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
// :683, by _win_bwd:632). The TPU kernels group G windows per grid step to
// make their matrix unit's products large, and each recomputes the logits
// and dP of its pairs. What bounds the pair on the H100: at config 2 (BH 32,
// S 256, w 64, Dh 1152, bf16) the bytes, q, k, v, do read and dq, dk, dv
// written once (132 MB, ~40 us); at the windowed training shape (BH 16,
// Dh 512, fp32) the band's five products (2.35 GFLOP, ~35 us at the fp32
// rate of the CUDA cores; the tensor cores run them as 3xTF32, three tf32
// products each at 495 TFLOP/s). A design that recomputes S and dP once per head-dim column
// block (the flash pair's) forms them 27 times at config 2, so the design
// (window_bwd.cuh) forms P and dS once per (query tile, key tile) pair
// instead, in three launches:
//  * pass A (tchvp_band_bwd_ds): S = Q K^T and dP = dO V^T over the whole
//    head dim for each (64-row query tile, 64-key tile of its span) on
//    mma.sync, the band masked per element, the dropout hash once per
//    element, P_drop and dS into a (2, BH, S, 64 span_tiles) scratch of the
//    inputs' dtype that stays in L2 (4.2 MB at config 2 and at the training
//    shape);
//  * pass B (tchvp_band_bwd_dq): dQ = dS K per (query tile, 128-column
//    block), the span's key tiles in order;
//  * pass B (tchvp_band_bwd_dkv): dK = dS^T Q and dV = P_drop^T dO per
//    (64-key tile, column block), the query tiles of the key tile's query
//    span ([(c0/w)*w, min(S, (c_last/w + 2)*w))) in order, the transposed
//    operands by ldmatrix.trans from the scratch.
// Every gradient element is summed by one thread in one order, with no
// atomics, so the bits are equal on repeat. Tiles may straddle windows (w
// need not divide 64) and S may be ragged: spans come from each tile's
// first and last index and the band is masked per element. The launchers
// take 1 <= w <= S; the wrapper passes min(w, S), since a window of S or
// more holds every pair. The scratch's width, the key tiles and their grid
// come from flash_attention.py's window_bwd_plan.
#include "window_bwd.cuh"
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

// Pass A: P_drop and dS of the band into scratch: (2, batch_heads,
// seq_len, 64 span_tiles) of the inputs' dtype, 16-byte aligned; q, k, v,
// dout as q in tchvp_band_fwd, lse and delta = rowsum(dout * out):
// (batch_heads, seq_len) fp32; span_tiles, key_tiles, tile_base from
// flash_attention.py's window_bwd_plan.
int tchvp_band_bwd_ds(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, void* scratch, int batch_heads, int seq_len, int head_dim,
                      int window, int span_tiles, int key_tiles, int tile_base, int is_bf16,
                      float scale, float dropout_rate, unsigned int drop_threshold, const void* seed,
                      void* stream) {
  const tchvp::WindowBwdParams a{q, k, v, dout, lse, delta, scratch, nullptr, nullptr, batch_heads,
      seq_len, head_dim, window, span_tiles, key_tiles, tile_base, scale, dropout_rate,
      drop_threshold, static_cast<const int*>(seed), nullptr, 0, 0, static_cast<cudaStream_t>(stream)};
  return tchvp::run_window_bwd<tchvp::kBand>(0, a, is_bf16);
}

// Pass B: dq (as q) = dS k from pass A's scratch.
int tchvp_band_bwd_dq(const void* scratch, const void* k, void* dq, int batch_heads, int seq_len,
                      int head_dim, int window, int span_tiles, int key_tiles, int tile_base,
                      int is_bf16, void* stream) {
  const tchvp::WindowBwdParams a{nullptr, k, nullptr, nullptr, nullptr, nullptr, const_cast<void*>(scratch),
      dq, nullptr, batch_heads, seq_len, head_dim, window, span_tiles, key_tiles, tile_base, 0.f, 0.f, 0u,
      nullptr, nullptr, 0, 0, static_cast<cudaStream_t>(stream)};
  return tchvp::run_window_bwd<tchvp::kBand>(1, a, is_bf16);
}

// Pass B: dk = dS^T q and dv = P_drop^T dout (as k, v) from pass A's scratch.
int tchvp_band_bwd_dkv(const void* scratch, const void* q, const void* dout, void* dk, void* dv,
                       int batch_heads, int seq_len, int head_dim, int window, int span_tiles,
                       int key_tiles, int tile_base, int is_bf16, void* stream) {
  const tchvp::WindowBwdParams a{q, nullptr, nullptr, dout, nullptr, nullptr, const_cast<void*>(scratch),
      dk, dv, batch_heads, seq_len, head_dim, window, span_tiles, key_tiles, tile_base, 0.f, 0.f, 0u,
      nullptr, nullptr, 0, 0, static_cast<cudaStream_t>(stream)};
  return tchvp::run_window_bwd<tchvp::kBand>(2, a, is_bf16);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
