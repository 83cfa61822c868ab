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
// :1139, by _win_halo_bwd): the CUDA-core bodies of attention_bwd.cuh in
// their kHalo mode, the flash geometry narrowed to the pairs each tile can
// hold, the band masked per element.
//  * dq: one block per (bh, 16-row query tile, column group); its key loop
//    runs over the tile's k_ext span.
//  * dk/dv: one block per (bh, 8-key tile of k_ext, column group); its query
//    loop runs over the local rows [max(0, (c0/w - 1)*w), min(S, (c_last/w
//    + 1)*w)), none for a tile of the masked halo. Every gradient element
//    is summed by one thread in one order, with no atomics, so the bits are
//    equal on repeat.
//  * Tiles may straddle windows (w need not divide by 16 or 8) and S need
//    not be a multiple of 16: spans come from each tile's first and last
//    index, and rows and columns stop at S and S + w.
// Bounds of the backward at the training shard: dq 0.81 GFLOP ~12 us, dk/dv
// 1.07 GFLOP ~16 us on the CUDA cores, where these bodies run (PERF.md).
#include "attention_bwd.cuh"
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

// dq; the tensors as in tchvp_halo_fwd, plus dout (as q) and lse, delta =
// rowsum(dout * out): (batch_heads, seq_len) fp32.
int tchvp_halo_bwd_dq(const void* q, const void* k_ext, const void* v_ext, const void* dout,
                      const void* lse, const void* delta, void* dq, int batch_heads,
                      int seq_len, int head_dim, int window, int is_bf16, float scale,
                      float dropout_rate, unsigned int drop_threshold, const void* seed,
                      const void* has_prev, void* stream) {
  return tchvp::run_bwd<tchvp::kHalo>(0, q, k_ext, v_ext, dout, lse, delta, dq, nullptr,
      nullptr, batch_heads, seq_len, head_dim, window, is_bf16, scale, dropout_rate,
      drop_threshold, seed, stream, has_prev);
}

// As tchvp_halo_bwd_dq, writing dk_ext and dv_ext (seq_len + window rows,
// the dtype of k_ext and v_ext), the halo window's rows included.
int tchvp_halo_bwd_dkv(const void* q, const void* k_ext, const void* v_ext, const void* dout,
                       const void* lse, const void* delta, void* dk_ext, void* dv_ext,
                       int batch_heads, int seq_len, int head_dim, int window, int is_bf16,
                       float scale, float dropout_rate, unsigned int drop_threshold,
                       const void* seed, const void* has_prev, void* stream) {
  return tchvp::run_bwd<tchvp::kHalo>(1, q, k_ext, v_ext, dout, lse, delta, nullptr, dk_ext,
      dv_ext, batch_heads, seq_len, head_dim, window, is_bf16, scale, dropout_rate,
      drop_threshold, seed, stream, has_prev);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
