// Flash-attention backward for Hopper (sm_90a) on the tensor cores: the dq
// kernel and the dk/dv kernel, plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of tchvp_tpu/kernels/flash_attention.py
// driven by _flash_bwd:343: _dq_kernel:235 (launched at :374; dq = dS K) and
// _dkv_kernel:280 (at :403; dv = P_drop^T dO, dk = dS^T Q), where
//   P = exp(q k^T * scale - lse),  dP = dO V^T,
//   dS = P * (dP * keep / (1 - rate) - delta) * scale,  P_drop = P * keep / (1 - rate),
// from the forward's fp32 lse and delta = rowsum(dO * out) (fp32, made by the
// wrapper); keep is the forward's dropout mask (flash_common.cuh) at the
// global (query row, key column).
//
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16 tensor cores;
// MUFU ex2 at 16 per clock per SM): at the training shape (BH 64, S 64, Dh
// 512, fp32) and the inference shape (BH 64, S 128, Dh 392, bf16) the bytes
// (q, k, v, do read and dq, dk, dv written once); at FCT's Dh 4-8 over S
// 4096-16384 the 2 BH S^2 exponentials (each kernel recomputes P); at Dh 64
// the products (5 of S x S x Dh per pair).
//
// Design: the flash forward's (flash_fwd.cu) column blocks, which recompute
// the logits, in both kernels. One launch each, no scratch, no atomics.
//  * dq: grid (BQ-row query tile, column block of 8 NT head-dim columns,
//    bh), BQ / 16 warps of 16 rows. The block walks the BK-key tiles of all S
//    in order:
//    S = Q K^T and dP = dO V^T over the whole head dim (qk_chunk twice; Dh
//    streamed in KC-column chunks), P = ex2(S scale log2e - lse log2e) and dS
//    formed in registers in the A-fragment layout, then dQ_blk += dS
//    K[:, blk] (pv_tile, K's column block by ldmatrix.trans as the forward
//    reads V). lse, delta and the rows' hashes stay in registers.
//  * dk/dv: grid (BK-key tile, column block, bh), BK / 16 warps of 16 keys.
//    The block walks the BQ-row query tiles of all S: S^T = K Q^T and dP^T = V
//    dO^T, so P^T and dS^T come out of the accumulator already in the
//    A-fragment layout; dV_blk += P_drop^T dO[:, blk] and dK_blk += dS^T
//    Q[:, blk]. The query tile's lse, delta and row hashes are staged once
//    per tile in shared memory (one buffer per ring slot).
//  * Every column block recomputes S and dP in the same order, so all of
//    them see the same P and dS bit for bit. Where one tile covers S (S <= 64
//    at the default blocks: the training shape) a block takes several column blocks in turn after
//    forming P and dS once, as few blocks per batch-head as give each SM one
//    (bwd_col_blocks): the logits are then recomputed SMs / BH times, not
//    once per column block. Tiles follow the head dim: (KC,
//    NT) = (16, 2) up to Dh 16, (32, 4) to 32, (64, 8) to 64, where one chunk
//    is the whole head dim and one column block covers it: the block's own
//    rows (Q and dO in dq, K and V in dk/dv) stay in shared memory and each
//    ring step is one tile of the other two, which the column-block products
//    read in place. Past Dh 64 each step is a KC chunk of all four, and the
//    tile's column block (K in dq; Q and dO in dk/dv) is a step of its own:
//    dq (64, 16) in bf16, (32, 8) in fp32; dk/dv (64, 8) and (32, 8), whose
//    two accumulators of 16 x 8 NT fp32 per warp stay in registers.
//  * Loads: one cp.async ring issued kStages - 1 steps ahead, 8-byte copies
//    or element loads where the rows, strides or pointers do not allow 16
//    (flash_tiles.cuh's copy_bytes rule); rows past S and columns past Dh are
//    zero-filled, so the zero columns padding Dh 4 and 8 to the mma's k of
//    16 add nothing. Key columns >= S take p = 0 in dq; query rows >= S take
//    p = 0 in dk/dv, whatever lse and delta hold there.
//  * q, k, v, do are (B, H, S, Dh) views with int64 batch, head and row
//    strides and unit stride along Dh; dq, dk and dv are written through
//    strides too, so `mha` passes its views and gets the views of (B, S, H,
//    Dh) buffers back without a copy. lse and delta are (B * H, S).
//  * Products: bf16 m16n8k16 -> fp32, P_drop and dS rounded to bf16 for the
//    second products (the TPU kernels multiply fp32 p); fp32 3xTF32 on
//    m16n8k8, each KC chunk and each tile's second product in its own
//    accumulator, added in fp32 (the tensor cores do not round to nearest).
//  * Every gradient element is summed by one thread in one order, so the
//    bits are equal on repeat and between strided and contiguous inputs.
//  * Blocks (BQ, BK) are the forward's (flash_fwd.cu, TCHVP_FLASH_BLOCKS),
//    passed by the wrapper from the forward's call: query rows per dq block
//    and per dk/dv step, keys per dq step and per dk/dv block.
#include "flash_tiles.cuh"

namespace tchvp {

template <typename T>
struct FlashBwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* g0;  // dq (dq kernel) or dk (dk/dv kernel)
  T* g1;  // dv (dk/dv kernel)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, d_sb, d_sh, d_ss;
  long long g0_sb, g0_sh, g0_ss, g1_sb, g1_sh, g1_ss;
  int heads, seq_len, head_dim;
  float scale, scale_log2;  // scale and scale * log2(e)
  int dropout;
  float inv_keep_prob;  // 1 / (1 - dropout rate)
  uint32_t drop_threshold;
  const int* seed;
  int copy_in, copy_out;  // bytes per copy of q, k, v, do; of the gradients: 16, 8, or 0
  int col_blocks;         // column blocks per block: 1, or several in turn where S <= 64
};

// Ring slots: 4 (bf16) or 2 (fp32) with the block's own rows resident, 2
// past Dh 64, where a step holds four chunks.
template <typename T, bool kResident>
__host__ __device__ constexpr int bwd_stages() {
  return kResident && sizeof(T) == 2 ? 4 : 2;
}

// A warp's 16 x 8 NT fp32 accumulator into rows [r0, r0 + ROWS) of a
// gradient: staged in shared memory (o_s, [ROWS][SV] elements of T), then
// written in 16- or 8-byte pieces or elements by the block's ROWS / 16
// warps. Ends with a barrier, so o_s is free again.
template <typename T, int NT, int ROWS>
__device__ __forceinline__ void store_block(T* o_s, const float (&acc)[NT][4], T* out, size_t ss,
                                            int r0, int d0, int seq_len, int head_dim, int copy_out) {
  constexpr int SV = flash_stride_v<T, NT>();
  constexpr int kCols = 8 * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* orow = o_s + (warp * 16 + g + 8 * r) * SV + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      orow[8 * j] = from_f32<T>(acc[j][2 * r]);
      orow[8 * j + 1] = from_f32<T>(acc[j][2 * r + 1]);
    }
  }
  __syncthreads();
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kCols / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += flash_threads<ROWS>()) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    if (r0 + r >= seq_len || d0 + c >= head_dim) continue;
    T* dst = out + (r0 + r) * ss + d0 + c;
    const T* src = o_s + r * SV + c;
    if (copy_out == 16) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else if (copy_out == 8) {
      *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
      if (d0 + c + kVec / 2 < head_dim)
        *reinterpret_cast<int2*>(dst + kVec / 2) = *reinterpret_cast<const int2*>(src + kVec / 2);
    } else {
      for (int e = 0; e < kVec && d0 + c + e < head_dim; ++e) dst[e] = src[e];
    }
  }
  __syncthreads();
}

template <int NT>
__device__ __forceinline__ void zero_cols(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc += A B^T over one KC chunk: a warp's 16 rows (a_s) x 8 NJ columns
// (b_s), qk_chunk's layout; fp32 adds each chunk's products from their own
// accumulator, as the forward does.
template <int KC, int NJ, typename T>
__device__ __forceinline__ void chunk_into(float (&acc)[NJ][4], const T* a_s, const T* b_s, int lane) {
  if constexpr (sizeof(T) == 2) {
    qk_chunk<KC>(acc, a_s, b_s, lane);
  } else {
    float part[NJ][4];
    zero_cols(part);
    qk_chunk<KC>(part, a_s, b_s, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}


template <typename T, int KC, int NT, bool kResident, int BQ, int BK>
__global__ void __launch_bounds__(flash_threads<BQ>()) flash_bwd_dq_kernel(const FlashBwdParams<T> p) {
  constexpr int kThreads = flash_threads<BQ>();
  constexpr int SQK = flash_stride_qk<T, KC>();
  constexpr int SV = flash_stride_v<T, NT>();
  constexpr int kStages = bwd_stages<T, kResident>();
  constexpr int kCols = 8 * NT;
  constexpr int kTileQ = BQ * SQK;  // elements of one chunk tile of Q or dO
  constexpr int kTileK = BK * SQK;  // of K or V
  constexpr int kStage = kResident ? 2 * kTileK : 2 * kTileQ + 2 * kTileK;
  constexpr int NJ = BK / 8;
  static_assert(!kResident || (KC == kCols && SQK == SV), "a resident tiling reads K's chunk as its block");
  static_assert(kResident || kStages * kStage >= (BK + BQ) * SV, "the ring holds a block and a stage");
  extern __shared__ __align__(16) unsigned char bwd_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  // This block's column blocks [cb0, cb_end); several only with one key tile.
  const int cb0 = blockIdx.y * p.col_blocks;
  const int cb_end = imin(cb0 + p.col_blocks, (p.head_dim + kCols - 1) / kCols);
  const int d0 = cb0 * kCols;
  const int bh = blockIdx.z;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int seq_len = p.seq_len, head_dim = p.head_dim, copy = p.copy_in;
  const size_t q_ss = p.q_ss, k_ss = p.k_ss, v_ss = p.v_ss, d_ss = p.d_ss;
  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + h * p.k_sh;
  const T* vb = p.v + b * p.v_sb + h * p.v_sh;
  const T* ob = p.dout + b * p.d_sb + h * p.d_sh;

  const int n_chunks = kResident ? 1 : (head_dim + KC - 1) / KC;
  const int n_tiles = (seq_len + BK - 1) / BK;
  // Resident: Q and dO [BQ][SQK] each, then the ring of (K, V) tiles.
  // Else: K's column block [BK][SV], then the ring of (Q, dO, K, V) chunks.
  // With several column blocks (one key tile, so no chunk is issued after
  // the first block's step) the ring's start takes every other block, and
  // the block after it stages dQ for its store.
  T* base = reinterpret_cast<T*>(bwd_smem);
  T* ring = base + (kResident ? 2 * kTileQ : BK * SV);

  int i_tile = 0, i_chunk = 0, i_slot = 0, i_cb = 0;
  auto issue = [&]() {
    if (i_tile < n_tiles) {
      const int k0 = i_tile * BK;
      if (i_chunk < n_chunks) {
        T* st = ring + i_slot * kStage;
        const int c0 = i_chunk * KC;
        if constexpr (kResident) {
          if (i_tile == 0) {
            load_tile<T, BQ, KC, SQK, kThreads>(base, qb, q0, seq_len, 0, head_dim, q_ss, copy);
            load_tile<T, BQ, KC, SQK, kThreads>(base + kTileQ, ob, q0, seq_len, 0, head_dim, d_ss, copy);
          }
        } else {
          load_tile<T, BQ, KC, SQK, kThreads>(st, qb, q0, seq_len, c0, head_dim, q_ss, copy);
          load_tile<T, BQ, KC, SQK, kThreads>(st + kTileQ, ob, q0, seq_len, c0, head_dim, d_ss, copy);
          st += 2 * kTileQ;
        }
        load_tile<T, BK, KC, SQK, kThreads>(st, kb, k0, seq_len, c0, head_dim, k_ss, copy);
        load_tile<T, BK, KC, SQK, kThreads>(st + kTileK, vb, k0, seq_len, c0, head_dim, v_ss, copy);
        i_slot = i_slot + 1 == kStages ? 0 : i_slot + 1;
        if (kResident) {
          ++i_tile;
        } else {
          ++i_chunk;
        }
      } else {
        load_tile<T, BK, kCols, SV, kThreads>((i_cb & 1) ? ring : base, kb, k0, seq_len, (cb0 + i_cb) * kCols,
                                              head_dim, k_ss, copy);
        if (++i_cb == cb_end - cb0) {
          i_cb = 0;
          i_chunk = 0;
          ++i_tile;
        }
      }
    }
    cp_async_commit();
  };

  float s_acc[NJ][4], dp_acc[NJ][4], dq_acc[NT][4];
  zero_cols(s_acc);
  zero_cols(dp_acc);
  zero_cols(dq_acc);
  T* dq_out = p.g0 + b * p.g0_sb + h * p.g0_sh;
  const float scale = p.scale, scale_log2 = p.scale_log2, inv_keep = p.inv_keep_prob;
  const bool dropout = p.dropout != 0;
  const uint32_t threshold = p.drop_threshold;
  const uint32_t hash_base = dropout ? dropout_base(p.seed, bh) : 0u;
  float lse_log2[2], delta[2];
  uint32_t row_h[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool ok = row < seq_len;
    lse_log2[r] = ok ? p.lse[(size_t)bh * seq_len + row] * kLog2e : 0.f;
    delta[r] = ok ? p.delta[(size_t)bh * seq_len + row] : 0.f;
    row_h[r] = row_hash(hash_base, row);
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();
  int slot = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const T* k_tile = nullptr;
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // this step staged for all; the slots of earlier steps free
      issue();
      const T* st = ring + slot * kStage;
      slot = slot + 1 == kStages ? 0 : slot + 1;
      const T* q_s = kResident ? base : st;
      const T* do_s = q_s + kTileQ;
      k_tile = kResident ? st : st + 2 * kTileQ;
      chunk_into<KC>(s_acc, q_s + warp * 16 * SQK, k_tile, lane);
      chunk_into<KC>(dp_acc, do_s + warp * 16 * SQK, k_tile + kTileK, lane);
    }

    // P and dS of the tile, in place of the logits and dP.
    const int k0 = kt * BK;
    const bool ragged = k0 + BK > seq_len;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float w = ragged && col >= seq_len ? 0.f : fast_exp2(s_acc[j][e] * scale_log2 - lse_log2[e >> 1]);
        float dp = dp_acc[j][e];
        if (dropout) dp = keep_hashed(row_h[e >> 1], col, threshold) ? dp * inv_keep : 0.f;
        s_acc[j][e] = w * (dp - delta[e >> 1]) * scale;
      }
    if constexpr (kResident) {
      pv_tile<NT>(dq_acc, s_acc, k_tile, lane);
    } else {
      for (int cb = cb0; cb < cb_end; ++cb) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // K's column block staged for all
        issue();
        pv_tile<NT>(dq_acc, s_acc, ((cb - cb0) & 1) ? ring : base, lane);
        if (cb_end - cb0 > 1) {  // the one key tile: this column block of dQ is done
          store_block<T, NT, BQ>(ring + BK * SV, dq_acc, dq_out, p.g0_ss, q0, cb * kCols, seq_len, head_dim,
                                 p.copy_out);
          zero_cols(dq_acc);
        }
      }
    }
    zero_cols(s_acc);
    zero_cols(dp_acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every slot free
  if (cb_end - cb0 == 1)
    store_block<T, NT, BQ>(base, dq_acc, dq_out, p.g0_ss, q0, d0, seq_len, head_dim, p.copy_out);
}

template <typename T, int KC, int NT, bool kResident, int BQ, int BK>
__global__ void __launch_bounds__(flash_threads<BK>()) flash_bwd_dkv_kernel(const FlashBwdParams<T> p) {
  constexpr int kThreads = flash_threads<BK>();
  constexpr int SQK = flash_stride_qk<T, KC>();
  constexpr int SV = flash_stride_v<T, NT>();
  constexpr int kStages = bwd_stages<T, kResident>();
  constexpr int kCols = 8 * NT;
  constexpr int kTileQ = BQ * SQK;
  constexpr int kTileK = BK * SQK;
  constexpr int kStage = kResident ? 2 * kTileQ : 2 * kTileQ + 2 * kTileK;
  constexpr int NJ = BQ / 8;
  static_assert(!kResident || (KC == kCols && SQK == SV), "a resident tiling reads Q's chunk as its block");
  static_assert(kResident || kStages * kStage >= (2 * BQ + BK) * SV, "the ring holds two blocks and a stage");
  extern __shared__ __align__(16) unsigned char bwd_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int cb0 = blockIdx.y * p.col_blocks;
  const int cb_end = imin(cb0 + p.col_blocks, (p.head_dim + kCols - 1) / kCols);
  const int d0 = cb0 * kCols;
  const int bh = blockIdx.z;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int seq_len = p.seq_len, head_dim = p.head_dim, copy = p.copy_in;
  const size_t q_ss = p.q_ss, k_ss = p.k_ss, v_ss = p.v_ss, d_ss = p.d_ss;
  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + h * p.k_sh;
  const T* vb = p.v + b * p.v_sb + h * p.v_sh;
  const T* ob = p.dout + b * p.d_sb + h * p.d_sh;
  const float* lse_bh = p.lse + (size_t)bh * seq_len;
  const float* delta_bh = p.delta + (size_t)bh * seq_len;

  const int n_chunks = kResident ? 1 : (head_dim + KC - 1) / KC;
  const int n_tiles = (seq_len + BQ - 1) / BQ;
  // Resident: K and V [BK][SQK] each, then the ring of (Q, dO) tiles. Else:
  // Q's and dO's column blocks [BQ][SV] each, then the ring of (Q, dO, K, V)
  // chunks; with several column blocks (one query tile) the ring's start
  // takes every other pair of blocks and the block after them stages dK and
  // dV. Past the ring, per slot, the query tile's lse * log2(e), delta and
  // row hashes.
  T* base = reinterpret_cast<T*>(bwd_smem);
  T* ring = base + (kResident ? 2 * kTileK : 2 * BQ * SV);
  float* lse_s = reinterpret_cast<float*>(ring + kStages * kStage);  // [kStages][BQ]
  float* delta_s = lse_s + kStages * BQ;                               // [kStages][BQ]
  uint32_t* hash_s = reinterpret_cast<uint32_t*>(delta_s + kStages * BQ);  // [kStages][BQ]
  const bool dropout = p.dropout != 0;
  const uint32_t hash_base = dropout ? dropout_base(p.seed, bh) : 0u;

  // The query tile's statistics go to buffer i_tile % kStages when its first
  // step is issued: a later tile's issue reaches that buffer only after a
  // barrier that follows this tile's last use of it.
  int i_tile = 0, i_chunk = 0, i_slot = 0, i_cb = 0;
  auto issue = [&]() {
    if (i_tile < n_tiles) {
      const int q0 = i_tile * BQ;
      if (i_chunk == 0) {
        for (int r = threadIdx.x; r < BQ; r += kThreads) {
          const int row = q0 + r;
          const bool ok = row < seq_len;
          const int at = (i_tile % kStages) * BQ + r;
          lse_s[at] = ok ? lse_bh[row] * kLog2e : 0.f;
          delta_s[at] = ok ? delta_bh[row] : 0.f;
          hash_s[at] = row_hash(hash_base, row);
        }
      }
      if (i_chunk < n_chunks) {
        T* st = ring + i_slot * kStage;
        const int c0 = i_chunk * KC;
        if constexpr (kResident) {
          if (i_tile == 0) {
            load_tile<T, BK, KC, SQK, kThreads>(base, kb, k0, seq_len, 0, head_dim, k_ss, copy);
            load_tile<T, BK, KC, SQK, kThreads>(base + kTileK, vb, k0, seq_len, 0, head_dim, v_ss, copy);
          }
        }
        load_tile<T, BQ, KC, SQK, kThreads>(st, qb, q0, seq_len, c0, head_dim, q_ss, copy);
        load_tile<T, BQ, KC, SQK, kThreads>(st + kTileQ, ob, q0, seq_len, c0, head_dim, d_ss, copy);
        if constexpr (!kResident) {
          load_tile<T, BK, KC, SQK, kThreads>(st + 2 * kTileQ, kb, k0, seq_len, c0, head_dim, k_ss, copy);
          load_tile<T, BK, KC, SQK, kThreads>(st + 2 * kTileQ + kTileK, vb, k0, seq_len, c0, head_dim, v_ss, copy);
        }
        i_slot = i_slot + 1 == kStages ? 0 : i_slot + 1;
        if (kResident) {
          ++i_tile;
        } else {
          ++i_chunk;
        }
      } else {
        T* blk = (i_cb & 1) ? ring : base;
        const int c0 = (cb0 + i_cb) * kCols;
        load_tile<T, BQ, kCols, SV, kThreads>(blk, qb, q0, seq_len, c0, head_dim, q_ss, copy);
        load_tile<T, BQ, kCols, SV, kThreads>(blk + BQ * SV, ob, q0, seq_len, c0, head_dim, d_ss, copy);
        if (++i_cb == cb_end - cb0) {
          i_cb = 0;
          i_chunk = 0;
          ++i_tile;
        }
      }
    }
    cp_async_commit();
  };

  float s_acc[NJ][4], dp_acc[NJ][4], dk_acc[NT][4], dv_acc[NT][4];
  zero_cols(s_acc);
  zero_cols(dp_acc);
  zero_cols(dk_acc);
  zero_cols(dv_acc);
  T* dk_out = p.g0 + b * p.g0_sb + h * p.g0_sh;
  T* dv_out = p.g1 + b * p.g1_sb + h * p.g1_sh;
  const float scale = p.scale, scale_log2 = p.scale_log2, inv_keep = p.inv_keep_prob;
  const uint32_t threshold = p.drop_threshold;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();
  int slot = 0;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const T* q_blk = nullptr;
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue();
      const T* st = ring + slot * kStage;
      slot = slot + 1 == kStages ? 0 : slot + 1;
      const T* k_s = kResident ? base : st + 2 * kTileQ;
      q_blk = st;
      chunk_into<KC>(s_acc, k_s + warp * 16 * SQK, st, lane);
      chunk_into<KC>(dp_acc, k_s + kTileK + warp * 16 * SQK, st + kTileQ, lane);
    }

    // P_drop^T and dS^T of the tile, in place of S^T and dP^T: row = key,
    // column = query row q0 + 8j + 2t + (e & 1).
    const int q0 = qt * BQ;
    const bool ragged = q0 + BQ > seq_len;
    const int buf = (qt % kStages) * BQ;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const float w = ragged && q0 + qc >= seq_len ? 0.f : fast_exp2(s_acc[j][e] * scale_log2 - lse_s[buf + qc]);
        float dp = dp_acc[j][e], w_drop = w;
        if (dropout) {
          const bool keep = keep_hashed(hash_s[buf + qc], key[e >> 1], threshold);
          dp = keep ? dp * inv_keep : 0.f;
          w_drop = keep ? w * inv_keep : 0.f;
        }
        dp_acc[j][e] = w * (dp - delta_s[buf + qc]) * scale;
        s_acc[j][e] = w_drop;
      }
    if constexpr (kResident) {
      pv_tile<NT>(dv_acc, s_acc, q_blk + kTileQ, lane);
      pv_tile<NT>(dk_acc, dp_acc, q_blk, lane);
    } else {
      for (int cb = cb0; cb < cb_end; ++cb) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // Q's and dO's column blocks staged for all
        issue();
        const T* blk = ((cb - cb0) & 1) ? ring : base;
        pv_tile<NT>(dv_acc, s_acc, blk + BQ * SV, lane);
        pv_tile<NT>(dk_acc, dp_acc, blk, lane);
        if (cb_end - cb0 > 1) {  // the one query tile: this column block of dK and dV is done
          T* stage = ring + 2 * BQ * SV;
          store_block<T, NT, BK>(stage, dk_acc, dk_out, p.g0_ss, k0, cb * kCols, seq_len, head_dim, p.copy_out);
          store_block<T, NT, BK>(stage, dv_acc, dv_out, p.g1_ss, k0, cb * kCols, seq_len, head_dim, p.copy_out);
          zero_cols(dk_acc);
          zero_cols(dv_acc);
        }
      }
    }
    zero_cols(s_acc);
    zero_cols(dp_acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (cb_end - cb0 == 1) {
    store_block<T, NT, BK>(base, dk_acc, dk_out, p.g0_ss, k0, d0, seq_len, head_dim, p.copy_out);
    store_block<T, NT, BK>(base, dv_acc, dv_out, p.g1_ss, k0, d0, seq_len, head_dim, p.copy_out);
  }
}

// Shared memory of one block: the resident or column-block tiles, the ring
// and, in dk/dv, the query tiles' statistics. The block's own rows are BQ
// (dq) or BK (dk/dv); its steps' tiles those and the other's.
template <typename T, int KC, int NT, bool kResident, int BQ, int BK>
size_t bwd_smem_bytes(bool dkv) {
  const size_t sqk = flash_stride_qk<T, KC>(), sv = flash_stride_v<T, NT>();
  const size_t own_rows = dkv ? BK : BQ, step_rows = dkv ? BQ : BK;
  const size_t own = kResident ? 2 * own_rows * sqk : (dkv ? 2 * (size_t)BQ : (size_t)BK) * sv;
  const size_t stage = kResident ? 2 * step_rows * sqk : 2 * ((size_t)BQ + BK) * sqk;
  const size_t ring = (size_t)bwd_stages<T, kResident>() * stage;
  const size_t stats = dkv ? (size_t)3 * bwd_stages<T, kResident>() * BQ * 4 : 0;
  return (own + ring) * sizeof(T) + stats;
}

// Column blocks per block past Dh 64: with one tile of the walked rows (S <=
// BK in dq, S <= BQ in dk/dv; S <= 64 at the default blocks) the logits are
// formed once and a block takes ceil(total / groups) column blocks in turn,
// groups (grid.y) = SMs / BH, at least 1 (2 at the training shape, BH 64;
// flash_bwd_breakdown.py times 1 and 4 groups and one column block per block
// beside it, PERF.md §6); else 1, each column block recomputing the logits.
inline int bwd_col_blocks(int total, bool one_tile, int batch_heads) {
  if (!one_tile) return 1;
  static int sms = 0;
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess) sms = 132;
  const int groups = imin(total, imax(1, sms / batch_heads));
  return (total + groups - 1) / groups;
}

template <int kWhich, typename T, int KC, int NT, bool kResident, int BQ, int BK>
cudaError_t launch_flash_bwd(FlashBwdParams<T> p, int batch_heads, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T, KC, NT, kResident, BQ, BK>(kWhich == 1);
  void (*kernel)(const FlashBwdParams<T>);
  if constexpr (kWhich == 0) {
    kernel = flash_bwd_dq_kernel<T, KC, NT, kResident, BQ, BK>;
  } else {
    kernel = flash_bwd_dkv_kernel<T, KC, NT, kResident, BQ, BK>;
  }
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int kOwn = kWhich == 0 ? BQ : BK, kWalked = kWhich == 0 ? BK : BQ;
  const int total = (p.head_dim + 8 * NT - 1) / (8 * NT);
  p.col_blocks = kResident ? 1 : bwd_col_blocks(total, p.seq_len <= kWalked, batch_heads);
  const dim3 grid((p.seq_len + kOwn - 1) / kOwn, (total + p.col_blocks - 1) / p.col_blocks, batch_heads);
  kernel<<<grid, flash_threads<kOwn>(), smem, stream>>>(p);
  return cudaGetLastError();
}

// The tiles of a head dim: (16, 2), (32, 4), (64, 8) with the block's own
// rows resident up to Dh 16, 32, 64; past that dq bf16 (64, 16), fp32 (32, 8)
// and dk/dv (64, 8), (32, 8), streamed in chunks.
template <int kWhich, typename T, int BQ, int BK>
cudaError_t dispatch_flash_bwd(const FlashBwdParams<T>& p, int batch_heads, cudaStream_t stream) {
  if (p.head_dim <= 16) return launch_flash_bwd<kWhich, T, 16, 2, true, BQ, BK>(p, batch_heads, stream);
  if (p.head_dim <= 32) return launch_flash_bwd<kWhich, T, 32, 4, true, BQ, BK>(p, batch_heads, stream);
  if (p.head_dim <= 64) return launch_flash_bwd<kWhich, T, 64, 8, true, BQ, BK>(p, batch_heads, stream);
  constexpr int kWideKC = sizeof(T) == 2 ? 64 : 32;
  constexpr int kWideNT = kWhich == 0 && sizeof(T) == 2 ? 16 : 8;
  return launch_flash_bwd<kWhich, T, kWideKC, kWideNT, false, BQ, BK>(p, batch_heads, stream);
}

// Each block candidate's instantiations, in its translation unit.
#define TCHVP_BWD_INST1(PREFIX, W, T, BQ, BK) \
  PREFIX template cudaError_t dispatch_flash_bwd<W, T, BQ, BK>(const FlashBwdParams<T>&, int, cudaStream_t);
#define TCHVP_BWD_INST(PREFIX, BQ, BK)                 \
  TCHVP_BWD_INST1(PREFIX, 0, float, BQ, BK)            \
  TCHVP_BWD_INST1(PREFIX, 1, float, BQ, BK)            \
  TCHVP_BWD_INST1(PREFIX, 0, __nv_bfloat16, BQ, BK)    \
  TCHVP_BWD_INST1(PREFIX, 1, __nv_bfloat16, BQ, BK)
#define TCHVP_BWD_INST_DEF(...) TCHVP_BWD_INST(, __VA_ARGS__)
#define TCHVP_BWD_INST_EXTERN(...) TCHVP_BWD_INST(extern, __VA_ARGS__)
TCHVP_UNIT_BLOCKS(TCHVP_BWD_INST_DEF)
TCHVP_EXTERN_BLOCKS(TCHVP_BWD_INST_EXTERN)

#if TCHVP_UNIT == 0
// The instantiation of a block candidate; an invalid value for any other.
template <int kWhich, typename T>
cudaError_t dispatch_flash_bwd_blocks(const FlashBwdParams<T>& p, int batch_heads, int block_q, int block_k,
                                      cudaStream_t stream) {
#define TCHVP_BWD_CASE(BQ, BK) \
  if (block_q == BQ && block_k == BK) return dispatch_flash_bwd<kWhich, T, BQ, BK>(p, batch_heads, stream);
  TCHVP_FLASH_BLOCKS(TCHVP_BWD_CASE)
#undef TCHVP_BWD_CASE
  return cudaErrorInvalidValue;
}

// `which` 0: dq into g0; 1: dk into g0 and dv into g1. st: the 12 input
// strides (q, k, v, do) then 3 per gradient.
template <typename T>
int run_flash_bwd(int which, const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* g0, void* g1, int batch, int heads, int seq_len, int head_dim,
                  const long long* st, float scale, float dropout_rate, unsigned int drop_threshold,
                  const void* seed, int block_q, int block_k, cudaStream_t stream) {
  FlashBwdParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.g0 = static_cast<T*>(g0);
  p.g1 = static_cast<T*>(g1);
  p.q_sb = st[0], p.q_sh = st[1], p.q_ss = st[2];
  p.k_sb = st[3], p.k_sh = st[4], p.k_ss = st[5];
  p.v_sb = st[6], p.v_sh = st[7], p.v_ss = st[8];
  p.d_sb = st[9], p.d_sh = st[10], p.d_ss = st[11];
  p.g0_sb = st[12], p.g0_sh = st[13], p.g0_ss = st[14];
  p.g1_sb = which == 1 ? st[15] : 0, p.g1_sh = which == 1 ? st[16] : 0, p.g1_ss = which == 1 ? st[17] : 0;
  p.heads = heads;
  p.seq_len = seq_len;
  p.head_dim = head_dim;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.dropout = dropout_rate > 0.f ? 1 : 0;
  p.inv_keep_prob = 1.f / (1.f - dropout_rate);
  p.drop_threshold = drop_threshold;
  p.seed = static_cast<const int*>(seed);
  p.copy_in = copy_bytes<T>(head_dim, st, 12, {q, k, v, dout});
  p.copy_out = which == 0 ? copy_bytes<T>(head_dim, st + 12, 3, {g0})
                          : copy_bytes<T>(head_dim, st + 12, 6, {g0, g1});
  return (int)(which == 0 ? dispatch_flash_bwd_blocks<0, T>(p, batch * heads, block_q, block_k, stream)
                          : dispatch_flash_bwd_blocks<1, T>(p, batch * heads, block_q, block_k, stream));
}

int check_and_run(int which, const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* g0, void* g1, int batch, int heads, int seq_len, int head_dim,
                  const long long* st, int n_strides, int is_bf16, float scale, float dropout_rate,
                  unsigned int drop_threshold, const void* seed, int block_q, int block_k, void* stream) {
  if (batch < 1 || heads < 1 || (long long)batch * heads > 65535 || seq_len < 1 || head_dim < 1 ||
      (dropout_rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_strides; ++i)
    if (st[i] < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run_flash_bwd<__nv_bfloat16>(which, q, k, v, dout, lse, delta, g0, g1, batch, heads, seq_len,
                                        head_dim, st, scale, dropout_rate, drop_threshold, seed, block_q,
                                        block_k, s);
  return run_flash_bwd<float>(which, q, k, v, dout, lse, delta, g0, g1, batch, heads, seq_len, head_dim, st,
                              scale, dropout_rate, drop_threshold, seed, block_q, block_k, s);
}
#endif  // TCHVP_UNIT == 0

}  // namespace tchvp

#if TCHVP_UNIT == 0
extern "C" {

// q, k, v, dout: (batch, heads, seq_len, head_dim) views, fp32 (is_bf16 0)
// or bf16 (is_bf16 1), unit stride along head_dim and (batch, head, row)
// strides in elements; dq: a view of the same shape and dtype written
// through its strides (any layout, such as the (B, S, H, Dh) buffer that
// `mha` passes); lse, delta: (batch * heads, seq_len) fp32 contiguous; seed:
// (1,) int32 on the device, read only when dropout_rate > 0; block_q,
// block_k: the forward's blocks, one of TCHVP_FLASH_BLOCKS. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
int tchvp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, void* dq, int batch, int heads, int seq_len, int head_dim,
                       long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                       long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long d_sb,
                       long long d_sh, long long d_ss, long long dq_sb, long long dq_sh, long long dq_ss,
                       int is_bf16, float scale, float dropout_rate, unsigned int drop_threshold,
                       const void* seed, int block_q, int block_k, void* stream) {
  const long long st[15] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                            d_sb, d_sh, d_ss, dq_sb, dq_sh, dq_ss};
  return tchvp::check_and_run(0, q, k, v, dout, lse, delta, dq, nullptr, batch, heads, seq_len, head_dim, st,
                              15, is_bf16, scale, dropout_rate, drop_threshold, seed, block_q, block_k, stream);
}

// As tchvp_flash_bwd_dq, writing dk and dv (views of k's shape and dtype,
// each through its own strides).
int tchvp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                        const void* delta, void* dk, void* dv, int batch, int heads, int seq_len, int head_dim,
                        long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long d_sb,
                        long long d_sh, long long d_ss, long long dk_sb, long long dk_sh, long long dk_ss,
                        long long dv_sb, long long dv_sh, long long dv_ss, int is_bf16, float scale,
                        float dropout_rate, unsigned int drop_threshold, const void* seed, int block_q,
                        int block_k, void* stream) {
  const long long st[18] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                            d_sb, d_sh, d_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  return tchvp::check_and_run(1, q, k, v, dout, lse, delta, dk, dv, batch, heads, seq_len, head_dim, st, 18,
                              is_bf16, scale, dropout_rate, drop_threshold, seed, block_q, block_k, stream);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif  // TCHVP_UNIT == 0
