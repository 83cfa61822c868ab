// Banded (windowed) attention for Hopper (sm_90a): forward, dq and dk/dv,
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of tchvp_tpu/kernels/flash_attention.py
// behind windowed_mha: _band_fwd_kernel (driven by _win_fwd), _band_dq_kernel
// and _band_dkv_kernel (driven by _win_bwd). Query window i (rows
// [i*w, (i+1)*w)) attends key windows i-1 and i, both indices < S
// (_band_mask); the first window has no predecessor. The forward writes
// `out` and the fp32 log-sum-exp of every row; the backward recomputes P
// from it. Dropout keeps weight (row, col) of the global (S, S) matrix by
// the squirrel3 hash of flash_common.cuh, bit for bit the TPU kernels' and
// the flash kernels' mask, so inside the band it equals
// attention_dropout_mask(seed, bh, S, S, rate).
//
// Design. The TPU kernels group G windows per grid step to make their
// matrix unit's products large, and pay (G+1)/(2G) of the logits in waste.
// Here the flash kernels of attention_fwd.cuh and attention_bwd.cuh run with
// the band on: each block keeps the flash geometry and only narrows its
// loop to the pairs its tile can hold.
//  * Forward and dq: one block per (bh, 16-row query tile); its key loop
//    runs over [max(0, (r0/w - 1)*w), min(S, (r_last/w + 1)*w)), from the
//    window before the tile's first row to the end of its last row's
//    window: at most 2w + 16 keys (2w when 16 divides w) instead of S.
//  * dk/dv: one block per (bh, 8-key tile); its query loop runs over the
//    key windows' own rows and the next window's, [(c0/w)*w, min(S,
//    (c_last/w + 2)*w)). Every gradient element is summed by one thread in
//    one order, with no atomics, so the bits are equal on repeat.
//  * A tile may straddle two windows (w need not divide by 16 or 8), so the
//    spans come from the tile's first and last index and the band is masked
//    per element; a row may see a whole 32-key tile masked, so masked
//    weights are set to 0 rather than left to exp(-1e30 - m). Columns start
//    at the span's low end, never below 0, so no negative index is hashed.
//  * A ragged S needs no padding: spans stop at S, as the flash kernels'.
//  * The launchers take 1 <= w <= S; the wrapper passes min(w, S), since a
//    window of S or more holds every pair: one window, the flash kernels'
//    arithmetic in the flash kernels' order.
//
// Bound on the H100 (3.35 TB/s; 989 TFLOP/s bf16 tensor cores; 67 TFLOP/s
// fp32 CUDA cores). At S 256, w 64 the band holds 28,672 (query, key) pairs
// per bh. Config 2's forward (BH 32, Dh 1152, bf16: q, k, v, out 75.5 MB,
// 4.23 GFLOP) is bound by bytes at ~22.5 us; the training shape (BH 16, Dh
// 512, fp32) by operations: forward 0.94 GFLOP ~14 us, dq 1.41 GFLOP ~21 us,
// dk/dv 1.88 GFLOP ~28 us. Like the flash kernels, this first version does
// its products on the fp32 CUDA cores and runs above those bounds
// (PERF.md); its band loop is what keeps the work O(S w) instead of O(S^2).
#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

extern "C" {

// q, k, v, out: (batch_heads, seq_len, head_dim) contiguous, fp32 (is_bf16 0)
// or bf16 (is_bf16 1); lse: (batch_heads, seq_len) fp32; window in tokens,
// 1..seq_len; seed: (1,) int32 on the device, read only when dropout_rate > 0
// (may be null otherwise). Returns the cudaError_t of the launch (0 on
// success); never synchronises.
int tchvp_band_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                   int batch_heads, int seq_len, int head_dim, int window, int is_bf16,
                   float scale, float dropout_rate, unsigned int drop_threshold,
                   const void* seed, void* stream) {
  return tchvp::run_fwd<true>(q, k, v, out, lse, batch_heads, seq_len, head_dim, window,
                              is_bf16, scale, dropout_rate, drop_threshold, seed, stream);
}

// dq over the band; the tensors as in tchvp_band_fwd, plus dout (as q) and
// lse, delta = rowsum(dout * out): (batch_heads, seq_len) fp32.
int tchvp_band_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int batch_heads,
                      int seq_len, int head_dim, int window, int is_bf16, float scale,
                      float dropout_rate, unsigned int drop_threshold, const void* seed,
                      void* stream) {
  return tchvp::run_bwd<true>(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch_heads,
                              seq_len, head_dim, window, is_bf16, scale, dropout_rate,
                              drop_threshold, seed, stream);
}

// As tchvp_band_bwd_dq, writing dk and dv (same shape and dtype as k, v).
int tchvp_band_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int batch_heads, int seq_len, int head_dim, int window, int is_bf16,
                       float scale, float dropout_rate, unsigned int drop_threshold,
                       const void* seed, void* stream) {
  return tchvp::run_bwd<true>(1, q, k, v, dout, lse, delta, nullptr, dk, dv, batch_heads,
                              seq_len, head_dim, window, is_bf16, scale, dropout_rate,
                              drop_threshold, seed, stream);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
