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
// Forward (replaces _band_fwd_kernel, flash_attention.py:476, launched at
// :611 by _win_fwd:593). What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s
// bf16 tensor cores; 67 TFLOP/s fp32 CUDA cores): at config 2 (BH 32, S
// 256, w 64, Dh 1152, bf16) q, k, v and out are 75.5 MB against 4.23 GFLOP
// of the band's products, so bytes bound it at ~22.5 us; at the windowed
// training shape (BH 16, Dh 512, fp32) the 0.94 GFLOP bind it at ~14 us on
// the CUDA cores (~1.9 us at the tensor cores' TF32 rate, x3 for 3xTF32).
// The design (window_fwd.cuh) is for the bytes and for the tensor cores:
// two passes over a (BH, S, span) fp32 scratch that stays in L2 (4.2 MB at
// config 2). Pass A forms the scaled, masked logits of each (64-row query
// tile, 64-key tile of its span) with mma.sync, the head dim streamed in
// 64-column chunks by cp.async; pass B takes each row's max from the
// scratch and multiplies P by a 128-column block of the span's V on the
// tensor cores, so its accumulator does not grow with Dh. Q and out cross
// device memory once; each key window serves two query tiles, the second
// read from L2. fp32 runs 3xTF32, bf16 rounds P to bf16 for P.V.
//
// Backward (dq: _band_dq_kernel:509 at :657; dk/dv: _band_dkv_kernel:543 at
// :683, by _win_bwd). The TPU kernels group G windows per grid step to make
// their matrix unit's products large, and pay (G+1)/(2G) of the logits in
// waste. Here the CUDA-core bodies of attention_bwd.cuh run with the band
// on: each block keeps the flash geometry and only narrows its loop to the
// pairs its tile can hold.
//  * dq: one block per (bh, 16-row query tile, column group); its key loop
//    runs over [max(0, (r0/w - 1)*w), min(S, (r_last/w + 1)*w)), from the
//    window before the tile's first row to the end of its last row's
//    window: at most 2w + 16 keys (2w when 16 divides w) instead of S.
//  * dk/dv: one block per (bh, 8-key tile, column group); its query loop
//    runs over the key windows' own rows and the next window's, [(c0/w)*w,
//    min(S, (c_last/w + 2)*w)). Every gradient element is summed by one
//    thread in one order, with no atomics, so the bits are equal on repeat.
//  * A tile may straddle two windows (w need not divide by 16 or 8), so the
//    spans come from the tile's first and last index and the band is masked
//    per element. Columns start at the span's low end, never below 0, so no
//    negative index is hashed. A ragged S needs no padding: spans stop at S.
//  * The launchers take 1 <= w <= S; the wrapper passes min(w, S), since a
//    window of S or more holds every pair. Then the backward runs the flash
//    kernels' arithmetic in their order.
// Bounds of the backward at the training shape: dq 1.41 GFLOP ~21 us, dk/dv
// 1.88 GFLOP ~28 us on the CUDA cores, where these bodies run (PERF.md).
#include "attention_bwd.cuh"
#include "window_fwd.cuh"

extern "C" {

// q, k, v, out: (batch_heads, seq_len, head_dim) contiguous, fp32 (is_bf16 0)
// or bf16 (is_bf16 1); lse: (batch_heads, seq_len) fp32; window in tokens,
// 1..seq_len; span_cols: the widest key span of a 64-row query tile, and
// scratch: (batch_heads, seq_len, scratch_cols) fp32, 16-byte aligned,
// scratch_cols a multiple of 4 that holds span_cols and one column per
// 64-key tile (both from flash_attention.py's window_plan); seed: (1,)
// int32 on the device, read only when dropout_rate > 0 (may be null
// otherwise). Returns the cudaError_t of the launches (0 on success); never
// synchronises.
int tchvp_band_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                   void* scratch, int batch_heads, int seq_len, int head_dim, int window,
                   int span_cols, int scratch_cols, int is_bf16, float scale, float dropout_rate,
                   unsigned int drop_threshold, const void* seed, void* stream) {
  return tchvp::run_window_fwd<tchvp::kBand>(q, k, v, out, lse, scratch, batch_heads, seq_len,
      head_dim, window, span_cols, scratch_cols, is_bf16, scale, dropout_rate, drop_threshold,
      seed, nullptr, stream);
}

// dq over the band; the tensors as in tchvp_band_fwd, plus dout (as q) and
// lse, delta = rowsum(dout * out): (batch_heads, seq_len) fp32.
int tchvp_band_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int batch_heads,
                      int seq_len, int head_dim, int window, int is_bf16, float scale,
                      float dropout_rate, unsigned int drop_threshold, const void* seed,
                      void* stream) {
  return tchvp::run_bwd<tchvp::kBand>(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr,
      batch_heads, seq_len, head_dim, window, is_bf16, scale, dropout_rate, drop_threshold,
      seed, stream);
}

// As tchvp_band_bwd_dq, writing dk and dv (same shape and dtype as k, v).
int tchvp_band_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int batch_heads, int seq_len, int head_dim, int window, int is_bf16,
                       float scale, float dropout_rate, unsigned int drop_threshold,
                       const void* seed, void* stream) {
  return tchvp::run_bwd<tchvp::kBand>(1, q, k, v, dout, lse, delta, nullptr, dk, dv,
      batch_heads, seq_len, head_dim, window, is_bf16, scale, dropout_rate, drop_threshold,
      seed, stream);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
