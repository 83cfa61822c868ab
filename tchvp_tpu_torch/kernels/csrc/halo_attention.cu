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
// Design. The bodies of attention_fwd.cuh and attention_bwd.cuh in their
// kHalo mode: the flash geometry, each block narrowed to the pairs its tile
// can hold, the band masked per element.
//  * Forward and dq: one block per (bh, 16-row query tile); its key loop
//    runs over the k_ext span [(r0/w)*w, min(S + w, (r_last/w + 2)*w)),
//    contiguous because k_ext is shifted one window left (the TPU kernel's
//    observation); with has_prev 0 it starts at w, so the halo costs shard
//    0 nothing and the tiles are the banded kernels' own.
//  * dk/dv: one block per (bh, 8-key tile of k_ext); its query loop runs
//    over the local rows [max(0, (c0/w - 1)*w), min(S, (c_last/w + 1)*w)),
//    none for a tile of the masked halo. Every gradient element is summed
//    by one thread in one order, with no atomics, so the bits are equal on
//    repeat.
//  * Tiles may straddle windows (w need not divide by 16 or 8) and S need
//    not be a multiple of 16: spans come from each tile's first and last
//    index, and rows and columns stop at S and S + w.
//
// Bound on the H100 (3.35 TB/s; 989 TFLOP/s bf16 tensor cores; 67 TFLOP/s
// fp32 CUDA cores). With has_prev 1 a shard of S 128, w 64 holds 16,384
// (query, key) pairs per bh. The windowed-training shard (BH 16, Dh 512,
// fp32: q, k_ext, v_ext, out 21.0 MB) is bound by operations: forward
// 0.54 GFLOP ~8.0 us, dq 0.81 GFLOP ~12 us, dk/dv 1.07 GFLOP ~16 us. The
// config-2 shard (BH 32, Dh 1152, bf16: 47.2 MB) is bound by bytes at ~14
// us. Like the flash and banded kernels, this first version does its
// products on the fp32 CUDA cores and runs above those bounds (PERF.md).
#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

extern "C" {

// q, out: (batch_heads, seq_len, head_dim); k_ext, v_ext: (batch_heads,
// seq_len + window, head_dim); all contiguous, fp32 (is_bf16 0) or bf16
// (is_bf16 1); lse: (batch_heads, seq_len) fp32; window >= 1 in tokens;
// seed: (1,) int32 on the device, read only when dropout_rate > 0 (may be
// null otherwise); has_prev: (1,) int32 on the device, 0 masks the halo
// window. Returns the cudaError_t of the launch (0 on success); never
// synchronises.
int tchvp_halo_fwd(const void* q, const void* k_ext, const void* v_ext, void* out, void* lse,
                   int batch_heads, int seq_len, int head_dim, int window, int is_bf16,
                   float scale, float dropout_rate, unsigned int drop_threshold,
                   const void* seed, const void* has_prev, void* stream) {
  return tchvp::run_fwd<tchvp::kHalo>(q, k_ext, v_ext, out, lse, batch_heads, seq_len,
      head_dim, window, is_bf16, scale, dropout_rate, drop_threshold, seed, stream, has_prev);
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
