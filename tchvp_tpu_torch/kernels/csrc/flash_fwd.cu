// Flash-attention forward for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel tchvp_tpu/kernels/flash_attention.py
// (_fwd_kernel:117, launched at :192 by _flash_fwd, from mha:824): online-
// softmax attention of every query row over every key, which writes `out` in
// the input dtype and the fp32 log-sum-exp, masks key columns >= S, and can
// apply attention-weight dropout from the squirrel3 hash of the global
// (row, col) index, bit for bit the TPU kernel's mask.
//
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16 tensor cores;
// MUFU ex2 at 16 per clock per SM): at the flagship's inference shape (BH 64,
// S 128, Dh 392, bf16) the bytes (q, k, v, out once: 25.7 MB, ~7.7 us)
// against 1.6 GFLOP; at FCT's Dh 4-8 over S 4096-16384 the BH * S^2
// exponentials (~0.26 ms at (2, 2, 16384, 4)); at Dh 64 the products.
//
// Design: one pass, the online softmax of FlashAttention-2 with the head dim
// split into output column blocks.
//  * Grid (BQ-row query tile, column block of 8 * NT head-dim columns, bh);
//    BQ / 16 warps of 16 rows. Each block walks the BK-key tiles of all S in
//    order: S = Q K^T over the whole head dim (mma.sync; Dh streamed in
//    KC-column chunks), the running max m and sum l in registers, P formed
//    straight in the A-fragment layout of the P.V mma, and a 16 x 8NT fp32
//    accumulator per warp for its rows of the column block. Every column
//    block recomputes the same logits in the same order, so all of them see
//    the same m and l bit for bit; block 0 writes the lse. One launch, no
//    scratch, any Dh: the accumulator is one column block wide whatever Dh
//    is (past Dh 128, 256 columns in bf16; past Dh 64, 128 in fp32).
//  * Tiles follow the head dim, so a small Dh does no padded work beyond
//    one mma step: (KC, NT) = (16, 2) up to Dh 16, (32, 4) to 32, (64, 8) to
//    64, (64, 16) to 128, then (64, 32) in bf16, and (32, 16) in fp32. When
//    one chunk holds the whole head dim (Dh <= 64, all of FCT) the Q tile is
//    loaded once and stays in shared memory; the chunks past that stream Q
//    and K together. Wider column blocks mean fewer blocks recomputing the
//    logits and reading K: at the inference shape 2 per query tile, not 4.
//  * Loads: one cp.async ring of steps, each step a (Q, K) chunk of a key
//    tile or the tile's V column block, issued kStages - 1 steps ahead. V
//    has two buffers of its own, or one where a key tile has kStages - 1
//    chunks or more (two bf16 blocks of 256 columns then fit an SM).
//    cp.async copies of 8 bytes where the rows, strides and pointers allow 8
//    and not 16 (Dh 4 bf16, Dh 98 fp32), element loads where they allow
//    neither (an odd Dh in bf16). Rows past S and columns past Dh are
//    zero-filled, so the zero columns that pad Dh 4 and 8 to the mma's k of
//    16 add nothing and no padded column is stored.
//  * q, k, v and out are (B, H, S, Dh) views with a batch, a head and a row
//    stride and unit stride along Dh: the (B, S, H, Dh) layout of the
//    projections goes in and comes out without a copy. lse is (B * H, S).
//  * Products: bf16 takes m16n8k16 bf16 -> fp32 (Q, K by ldmatrix, V by
//    ldmatrix.trans), P rounded to bf16 for P.V (the TPU kernel multiplies
//    fp32 p). fp32 takes 3xTF32 on m16n8k8: the tensor cores' accumulation
//    does not round to nearest, so in fp32 each KC chunk of Q K^T and each
//    key tile's P.V has its own accumulator, added in fp32. The fp32 P.V takes
//    the keys of an 8-key step in the order 0, 2, 4, 6, 1, 3, 5, 7 (P's
//    accumulator layout gives a thread keys 2t, 2t + 1, the A fragment wants
//    t, t + 4), and reads V's rows in the same order.
//  * Softmax in base 2: the logits are scaled by scale * log2(e), p =
//    ex2(x - m); key columns >= S take the finite kNegInf, so p is 0 there
//    and no row sees -inf - -inf. l takes the undropped p, as _fwd_kernel
//    does; dropout then keeps p / (1 - rate) at the global (row, col), the
//    row's half of the hash taken once per row.
//  * Every element is summed by one thread in one order, with no atomics,
//    so the bits are equal on repeat.
//  * Blocks (BQ, BK), query rows per block and keys per tile, are template
//    parameters, one of TCHVP_FLASH_BLOCKS (flash_common.cuh), chosen per call
//    by the wrapper (kernels/autotune.py). A 128-row block is 8 warps of 16
//    rows sharing each K/V stage, so a warp holds the same registers as in a
//    64-row block and K and V are read once per 128 query rows; BK 32 halves
//    the logits' registers and the K/V stage.
#include "flash_tiles.cuh"

namespace tchvp {

template <typename T>
struct FlashFwdParams {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  float* lse;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int heads, seq_len, head_dim;
  float scale_log2;  // scale * log2(e)
  int dropout;
  float inv_keep_prob;  // 1 / (1 - dropout rate)
  uint32_t drop_threshold;
  const int* seed;
  int copy_in, copy_out;  // bytes per copy of q, k, v; of out: 16, 8, or 0 (elements)
};

template <typename T, int KC, int NT, int BQ, int BK>
__global__ void __launch_bounds__(flash_threads<BQ>()) flash_fwd_kernel(const FlashFwdParams<T> p) {
  constexpr int kThreads = flash_threads<BQ>();
  constexpr int SQK = flash_stride_qk<T, KC>();
  constexpr int SV = flash_stride_v<T, NT>();
  constexpr int kStages = flash_stages<T>();
  constexpr int kCols = 8 * NT;  // head-dim columns per block
  extern __shared__ __align__(16) unsigned char flash_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int d0 = blockIdx.y * kCols;
  const int bh = blockIdx.z;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int seq_len = p.seq_len, head_dim = p.head_dim, copy = p.copy_in;
  const size_t q_ss = p.q_ss, k_ss = p.k_ss, v_ss = p.v_ss;
  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + h * p.k_sh;
  const T* vb = p.v + b * p.v_sb + h * p.v_sh;

  const int n_chunks = (head_dim + KC - 1) / KC;
  const int n_tiles = (seq_len + BK - 1) / BK;
  const bool q_once = n_chunks == 1;  // Q stays in shared memory
  const int stage = (q_once ? BK : BQ + BK) * SQK;  // elements
  const bool two_v = flash_v_buffers<T>(n_chunks) == 2;
  T* v_ring = reinterpret_cast<T*>(flash_smem);     // [1 or 2][BK][SV]
  T* q_res = v_ring + (two_v ? 2 : 1) * BK * SV;    // [BQ][SQK] when q_once
  T* ring = q_res + (q_once ? BQ * SQK : 0);        // [kStages][stage]

  // The steps, in order: for each key tile its n_chunks (Q, K) chunks, then
  // its V block. `issue` loads the next one not yet issued (i_tile, i_chunk;
  // chunk n_chunks is the V block) into the next slot.
  int i_tile = 0, i_chunk = 0, i_slot = 0;
  auto issue = [&]() {
    if (i_tile < n_tiles) {
      const int k0 = i_tile * BK;
      if (i_chunk < n_chunks) {
        T* st = ring + i_slot * stage;
        if (q_once) {
          if (i_tile == 0)
            load_tile<T, BQ, KC, SQK, kThreads>(q_res, qb, q0, seq_len, 0, head_dim, q_ss, copy);
        } else {
          load_tile<T, BQ, KC, SQK, kThreads>(st, qb, q0, seq_len, i_chunk * KC, head_dim, q_ss, copy);
          st += BQ * SQK;
        }
        load_tile<T, BK, KC, SQK, kThreads>(st, kb, k0, seq_len, i_chunk * KC, head_dim, k_ss, copy);
        i_slot = i_slot + 1 == kStages ? 0 : i_slot + 1;
        ++i_chunk;
      } else {
        load_tile<T, BK, kCols, SV, kThreads>(v_ring + (two_v ? i_tile & 1 : 0) * BK * SV, vb, k0, seq_len,
                                              d0, head_dim, v_ss, copy);
        i_chunk = 0;
        ++i_tile;
      }
    }
    cp_async_commit();
  };

  constexpr int NJ = BK / 8;  // the logits' m16n8 tiles per warp
  float s_acc[NJ][4], o_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in base-2 logits
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale_log2, inv_keep = p.inv_keep_prob;
  const bool dropout = p.dropout != 0;
  const uint32_t threshold = p.drop_threshold;
  const uint32_t hash_base = dropout ? dropout_base(p.seed, bh) : 0u;
  const uint32_t row_h[2] = {row_hash(hash_base, row[0]), row_hash(hash_base, row[1])};

  // Every step commits one group (empty past the last step), so waiting for
  // all but kStages - 2 groups leaves the current step staged.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();
  int slot = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // this chunk staged for all; the slots of earlier steps free
      issue();
      const T* st = ring + slot * stage;
      slot = slot + 1 == kStages ? 0 : slot + 1;
      const T* q_s = (q_once ? q_res : st) + warp * 16 * SQK;
      const T* k_s = q_once ? st : st + BQ * SQK;
      if constexpr (sizeof(T) == 2) {
        qk_chunk<KC>(s_acc, q_s, k_s, lane);
      } else {
        float part[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
        qk_chunk<KC>(part, q_s, k_s, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s_acc[j][e] += part[j][e];
      }
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile's V staged for all
    issue();

    // The tile's logits are complete: online softmax, then P.V.
    const int k0 = kt * BK;
    const bool ragged = k0 + BK > seq_len;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_acc[j][e] * scale_log2;
        if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= seq_len) x = kNegInf;
        s_acc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // The 4 lanes of a row group hold the tile's keys between them.
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = fast_exp2(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o_acc[j][2 * r] *= alpha;
        o_acc[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float w = fast_exp2(s_acc[j][e] - m[e >> 1]);
        l[e >> 1] += w;
        if (dropout)
          w = keep_hashed(row_h[e >> 1], k0 + 8 * j + 2 * t + (e & 1), threshold) ? w * inv_keep : 0.f;
        s_acc[j][e] = w;
      }
    pv_tile<NT>(o_acc, s_acc, v_ring + (two_v ? kt & 1 : 0) * BK * SV, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();  // every slot free

  // out = acc / l, staged in shared memory (from V's first buffer on), then
  // written in 16- or 8-byte pieces; lse = (m + log2 l) ln 2 from column
  // block 0.
  T* o_s = v_ring;  // [BQ][SV]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float safe_l = sum == 0.f ? 1.f : sum;
    T* orow = o_s + (warp * 16 + g + 8 * r) * SV + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      orow[8 * j] = from_f32<T>(o_acc[j][2 * r] / safe_l);
      orow[8 * j + 1] = from_f32<T>(o_acc[j][2 * r + 1] / safe_l);
    }
    if (blockIdx.y == 0 && t == 0 && row[r] < seq_len)
      p.lse[(size_t)bh * seq_len + row[r]] = (m[r] + log2f(safe_l)) * kLn2;
  }
  __syncthreads();
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kCols / kVec;
  T* ob = p.out + b * p.o_sb + h * p.o_sh;
  const size_t o_ss = p.o_ss;
  const int copy_out = p.copy_out;
  for (int i = threadIdx.x; i < BQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    if (q0 + r >= seq_len || d0 + c >= head_dim) continue;
    T* dst = ob + (q0 + r) * o_ss + d0 + c;
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
}

// Shared memory of one block: V's buffers, the resident Q tile when one
// chunk holds Dh, and the (Q, K) ring; at least the output's [BQ][SV]
// staging.
template <typename T, int KC, int NT, int BQ, int BK>
size_t flash_smem_bytes(int head_dim) {
  const bool q_once = head_dim <= KC;
  const int v_bufs = flash_v_buffers<T>((head_dim + KC - 1) / KC);
  const size_t v_bytes = (size_t)v_bufs * BK * flash_stride_v<T, NT>() * sizeof(T);
  const size_t q_bytes = q_once ? (size_t)BQ * flash_stride_qk<T, KC>() * sizeof(T) : 0;
  const size_t ring = (size_t)flash_stages<T>() * (q_once ? BK : BQ + BK) * flash_stride_qk<T, KC>() * sizeof(T);
  const size_t out = (size_t)BQ * flash_stride_v<T, NT>() * sizeof(T);
  return v_bytes + q_bytes + ring > out ? v_bytes + q_bytes + ring : out;
}

template <typename T, int KC, int NT, int BQ, int BK>
cudaError_t launch_flash_fwd(const FlashFwdParams<T>& p, int batch_heads, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<T, KC, NT, BQ, BK>(p.head_dim);
  auto kernel = flash_fwd_kernel<T, KC, NT, BQ, BK>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_len + BQ - 1) / BQ, (p.head_dim + 8 * NT - 1) / (8 * NT), batch_heads);
  kernel<<<grid, flash_threads<BQ>(), smem, stream>>>(p);
  return cudaGetLastError();
}

// The tiles of a head dim: (KC, NT) = (16, 2) to Dh 16, (32, 4) to 32, (64, 8)
// to 64. Past that, bf16 takes (64, 16) to 128, then (64, 32): fewer column
// blocks, each recomputing the logits (2 at Dh 392, not 4); fp32, whose P.V
// keeps a second accumulator, takes (32, 16), whose ring and one V buffer
// (89 KB) let two blocks share an SM.
template <typename T, int BQ, int BK>
cudaError_t dispatch_flash_fwd(const FlashFwdParams<T>& p, int batch_heads, cudaStream_t stream) {
  if (p.head_dim <= 16) return launch_flash_fwd<T, 16, 2, BQ, BK>(p, batch_heads, stream);
  if (p.head_dim <= 32) return launch_flash_fwd<T, 32, 4, BQ, BK>(p, batch_heads, stream);
  if (p.head_dim <= 64) return launch_flash_fwd<T, 64, 8, BQ, BK>(p, batch_heads, stream);
  if constexpr (sizeof(T) == 2) {
    if (p.head_dim <= 128) return launch_flash_fwd<T, 64, 16, BQ, BK>(p, batch_heads, stream);
    return launch_flash_fwd<T, 64, 32, BQ, BK>(p, batch_heads, stream);
  } else {
    return launch_flash_fwd<T, 32, 16, BQ, BK>(p, batch_heads, stream);
  }
}

// Each block candidate's instantiations, in its translation unit.
#define TCHVP_FWD_INST(PREFIX, BQ, BK)                                                                    \
  PREFIX template cudaError_t dispatch_flash_fwd<float, BQ, BK>(const FlashFwdParams<float>&, int,        \
                                                                cudaStream_t);                            \
  PREFIX template cudaError_t dispatch_flash_fwd<__nv_bfloat16, BQ, BK>(const FlashFwdParams<__nv_bfloat16>&, \
                                                                        int, cudaStream_t);
#define TCHVP_FWD_INST_DEF(...) TCHVP_FWD_INST(, __VA_ARGS__)
#define TCHVP_FWD_INST_EXTERN(...) TCHVP_FWD_INST(extern, __VA_ARGS__)
TCHVP_UNIT_BLOCKS(TCHVP_FWD_INST_DEF)
TCHVP_EXTERN_BLOCKS(TCHVP_FWD_INST_EXTERN)

#if TCHVP_UNIT == 0
// The instantiation of a block candidate (block_q, block_k); an invalid
// value for any other.
template <typename T>
cudaError_t dispatch_flash_fwd_blocks(const FlashFwdParams<T>& p, int batch_heads, int block_q, int block_k,
                                      cudaStream_t stream) {
#define TCHVP_FWD_CASE(BQ, BK) \
  if (block_q == BQ && block_k == BK) return dispatch_flash_fwd<T, BQ, BK>(p, batch_heads, stream);
  TCHVP_FLASH_BLOCKS(TCHVP_FWD_CASE)
#undef TCHVP_FWD_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
int run_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                  int heads, int seq_len, int head_dim, const long long* st, float scale,
                  float dropout_rate, unsigned int drop_threshold, const void* seed, int block_q,
                  int block_k, cudaStream_t stream) {
  FlashFwdParams<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.out = static_cast<T*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_sb = st[0], p.q_sh = st[1], p.q_ss = st[2];
  p.k_sb = st[3], p.k_sh = st[4], p.k_ss = st[5];
  p.v_sb = st[6], p.v_sh = st[7], p.v_ss = st[8];
  p.o_sb = st[9], p.o_sh = st[10], p.o_ss = st[11];
  p.heads = heads;
  p.seq_len = seq_len;
  p.head_dim = head_dim;
  p.scale_log2 = scale * kLog2e;
  p.dropout = dropout_rate > 0.f ? 1 : 0;
  p.inv_keep_prob = 1.f / (1.f - dropout_rate);
  p.drop_threshold = drop_threshold;
  p.seed = static_cast<const int*>(seed);
  p.copy_in = copy_bytes<T>(head_dim, st, 9, {q, k, v});
  p.copy_out = copy_bytes<T>(head_dim, st + 9, 3, {out});
  return (int)dispatch_flash_fwd_blocks<T>(p, batch * heads, block_q, block_k, stream);
}
#endif  // TCHVP_UNIT == 0

}  // namespace tchvp

#if TCHVP_UNIT == 0

extern "C" {

// q, k, v, out: (batch, heads, seq_len, head_dim) views, fp32 (is_bf16 0) or
// bf16 (is_bf16 1), with unit stride along head_dim and the (batch, head,
// row) strides in elements q_sb, q_sh, q_ss, ..., o_ss (any layout; 16-byte
// copies where they and the rows are multiples of 16 bytes); lse: (batch *
// heads, seq_len) fp32 contiguous; seed: (1,) int32 on the device, read only
// when dropout_rate > 0 (may be null otherwise); block_q, block_k: one of
// TCHVP_FLASH_BLOCKS. Returns the cudaError_t of the launch (0 on success);
// never synchronises.
int tchvp_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                    int heads, int seq_len, int head_dim, long long q_sb, long long q_sh,
                    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                    int is_bf16, float scale, float dropout_rate, unsigned int drop_threshold,
                    const void* seed, int block_q, int block_k, void* stream) {
  if (batch < 1 || heads < 1 || (long long)batch * heads > 65535 || seq_len < 1 || head_dim < 1 ||
      (dropout_rate > 0.f && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  for (long long s : st)
    if (s < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tchvp::run_flash_fwd<__nv_bfloat16>(q, k, v, out, lse, batch, heads, seq_len, head_dim,
                                               st, scale, dropout_rate, drop_threshold, seed, block_q,
                                               block_k, s);
  return tchvp::run_flash_fwd<float>(q, k, v, out, lse, batch, heads, seq_len, head_dim, st, scale,
                                     dropout_rate, drop_threshold, seed, block_q, block_k, s);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif  // TCHVP_UNIT == 0
