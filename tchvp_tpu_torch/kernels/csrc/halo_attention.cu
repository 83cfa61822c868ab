// Halo (sequence-parallel) windowed attention for Hopper (sm_90a): forward,
// dq and dk/dv, plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of tchvp_tpu/kernels/flash_attention.py
// behind windowed_mha_halo: _halo_fwd_kernel (driven by _win_halo_fwd),
// _halo_dq_kernel and _halo_dkv_kernel (driven by _win_halo_bwd). Under
// sequence parallelism each shard holds S contiguous tokens of the sequence;
// k and v carry one extra leading window of w tokens, the left neighbour's
// last window (the halo, exchanged outside the kernel), so k_ext and v_ext
// have S + w rows. Local query row r sees k_ext column c when c's window is
// r's or the one after it (_halo_band_mask); has_prev, a (1,) int32 on the
// device read inside the kernel as the dropout seed is, masks the halo
// window where it is 0 (shard 0, the true sequence start), so no rank needs
// a host sync or a branch of its own. The forward writes `out` and the fp32
// log-sum-exp of every local row; the backward recomputes P from it, and
// dk/dv covers all S + w rows of k_ext: the halo window's gradient goes back
// to its owner by the reverse exchange.
//
// Dropout keeps weight (r, c) by the squirrel3 hash of flash_common.cuh at
// the shard-local column c - w, as the TPU kernels do (`col0 - window`): the
// halo window hashes columns -w..-1, which the uint32 cast wraps to
// 2^32 - w..2^32 - 1, exactly as JAX's int32 -> uint32 cast does.
//
// Forward (replaces _halo_fwd_kernel, flash_attention.py:908, launched at
// :1057 by _win_halo_fwd:1038). What bounds it on the H100 (3.35 TB/s; 989
// TFLOP/s bf16 tensor cores; 67 TFLOP/s fp32 CUDA cores): the config-2
// shard (BH 32, S 128, k_ext 192, Dh 1152, bf16: q, k_ext, v_ext, out 47.2
// MB, 2.42 GFLOP) is bound by bytes at ~14 us; the windowed-training shard
// (BH 16, Dh 512, fp32: 21.0 MB, 0.54 GFLOP) by operations at ~8 us on the
// CUDA cores. The design is window_fwd.cuh's, as the banded forward's
// (band_attention.cu): pass A writes each (64-row query tile, 64-key tile
// of its k_ext span) of scaled, masked logits to an L2-resident scratch
// with mma.sync, pass B multiplies P by a 128-column block of V on the
// tensor cores. The k_ext span [(r0/w)*w, min(S + w, (r_last/w + 2)*w)) is
// contiguous because k_ext is shifted one window left (the TPU kernel's
// observation); with has_prev 0 it starts at w, so the halo costs shard 0
// nothing.
//
// Backward (dq: _halo_dq_kernel:947 at :1103; dk/dv: _halo_dkv_kernel:985 at
// :1139, by _win_halo_bwd:1078). What bounds the pair on the H100: the
// config-2 shard (BH 32, S 128, k_ext 192, Dh 1152, bf16) by bytes (~25 us),
// the windowed-training shard (BH 16, Dh 512, fp32) by the halo band's five
// products (~20 us at the CUDA cores' fp32 rate). The design is
// window_bwd.cuh's, as the banded backward's (band_attention.cu), in its
// kHalo mode: pass A (tchvp_halo_bwd_ds) forms P_drop and dS once per
// (64-row query tile, 64-key tile of its k_ext span) on mma.sync into an
// L2-resident scratch; pass B forms dQ = dS K_ext (tchvp_halo_bwd_dq) and
// dK_ext = dS^T Q, dV_ext = P_drop^T dO over all S + w rows of k_ext
// (tchvp_halo_bwd_dkv), whose query span of local rows is [max(0, (c0/w -
// 1)*w), min(S, (c_last/w + 1)*w)), none for a tile of the masked halo
// window. Key tiles start at k_ext column w + 64 j (window_bwd.cuh), so
// with has_prev 0 the halo backward walks the band's tiles on the local
// sequence in the band's order and equals it bit for bit. Every gradient
// element is summed by one thread in one order, with no atomics, so the bits
// are equal on repeat.
#include "window_bwd.cuh"
#include "window_fwd.cuh"

extern "C" {

// q, out: (batch_heads, seq_len, head_dim); k_ext, v_ext: (batch_heads,
// seq_len + window, head_dim); all contiguous, fp32 (is_bf16 0) or bf16
// (is_bf16 1); lse: (batch_heads, seq_len) fp32; window >= 1 in tokens;
// span_cols: the widest k_ext span of a 64-row query tile, and scratch:
// (batch_heads, seq_len, scratch_cols) fp32, 16-byte aligned, scratch_cols
// a multiple of 4 that holds span_cols and one column per 64-key tile (both
// from flash_attention.py's window_plan); seed: (1,) int32 on the device,
// read only when dropout_rate > 0 (may be null otherwise); has_prev: (1,)
// int32 on the device, 0 masks the halo window. Returns the cudaError_t of
// the launches (0 on success); never synchronises.
int tchvp_halo_fwd(const void* q, const void* k_ext, const void* v_ext, void* out, void* lse,
                   void* scratch, int batch_heads, int seq_len, int head_dim, int window,
                   int span_cols, int scratch_cols, int is_bf16, float scale, float dropout_rate,
                   unsigned int drop_threshold, const void* seed, const void* has_prev,
                   void* stream) {
  return tchvp::run_window_fwd<tchvp::kHalo>(q, k_ext, v_ext, out, lse, scratch, batch_heads,
      seq_len, head_dim, window, span_cols, scratch_cols, is_bf16, scale, dropout_rate,
      drop_threshold, seed, has_prev, stream);
}

// Pass A: P_drop and dS of the halo band into scratch: (2, batch_heads,
// seq_len, 64 span_tiles) of the inputs' dtype, 16-byte aligned; q, k_ext,
// v_ext, dout as in tchvp_halo_fwd, lse and delta = rowsum(dout * out):
// (batch_heads, seq_len) fp32; span_tiles, key_tiles, tile_base from
// flash_attention.py's window_bwd_plan; has_prev as in tchvp_halo_fwd.
int tchvp_halo_bwd_ds(const void* q, const void* k_ext, const void* v_ext, const void* dout,
                      const void* lse, const void* delta, void* scratch, int batch_heads, int seq_len,
                      int head_dim, int window, int span_tiles, int key_tiles, int tile_base,
                      int is_bf16, float scale, float dropout_rate, unsigned int drop_threshold,
                      const void* seed, const void* has_prev, void* stream) {
  const tchvp::WindowBwdParams a{q, k_ext, v_ext, dout, lse, delta, scratch, nullptr, nullptr,
      batch_heads, seq_len, head_dim, window, span_tiles, key_tiles, tile_base, scale, dropout_rate,
      drop_threshold, static_cast<const int*>(seed), static_cast<const int*>(has_prev), 0, 0,
      static_cast<cudaStream_t>(stream)};
  return tchvp::run_window_bwd<tchvp::kHalo>(0, a, is_bf16);
}

// Pass B: dq (as q) = dS k_ext from pass A's scratch.
int tchvp_halo_bwd_dq(const void* scratch, const void* k_ext, void* dq, int batch_heads, int seq_len,
                      int head_dim, int window, int span_tiles, int key_tiles, int tile_base,
                      int is_bf16, const void* has_prev, void* stream) {
  const tchvp::WindowBwdParams a{nullptr, k_ext, nullptr, nullptr, nullptr, nullptr,
      const_cast<void*>(scratch), dq, nullptr, batch_heads, seq_len, head_dim, window, span_tiles,
      key_tiles, tile_base, 0.f, 0.f, 0u, nullptr, static_cast<const int*>(has_prev), 0, 0,
      static_cast<cudaStream_t>(stream)};
  return tchvp::run_window_bwd<tchvp::kHalo>(1, a, is_bf16);
}

// Pass B: dk_ext = dS^T q and dv_ext = P_drop^T dout (seq_len + window rows,
// the halo window's included) from pass A's scratch.
int tchvp_halo_bwd_dkv(const void* scratch, const void* q, const void* dout, void* dk_ext, void* dv_ext,
                       int batch_heads, int seq_len, int head_dim, int window, int span_tiles,
                       int key_tiles, int tile_base, int is_bf16, const void* has_prev, void* stream) {
  const tchvp::WindowBwdParams a{q, nullptr, nullptr, dout, nullptr, nullptr, const_cast<void*>(scratch),
      dk_ext, dv_ext, batch_heads, seq_len, head_dim, window, span_tiles, key_tiles, tile_base, 0.f, 0.f,
      0u, nullptr, static_cast<const int*>(has_prev), 0, 0, static_cast<cudaStream_t>(stream)};
  return tchvp::run_window_bwd<tchvp::kHalo>(2, a, is_bf16);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
