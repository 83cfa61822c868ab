// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel tchvp_tpu/kernels/flash_attention.py
// (_fwd_kernel, driven by _flash_fwd): blockwise online-softmax attention
// over (BH, S, Dh) that writes `out` in the input dtype and the fp32
// log-sum-exp, masks key columns >= S, and can apply attention-weight
// dropout from the squirrel3 hash of the global (row, col) index, bit for
// bit the TPU kernel's mask.
//
// Design: attention_fwd.cuh's kernel: each 16-row query tile walks every key
// of the sequence; any head dim, in column groups of at most 1280 columns
// above that (flash_common.cuh's ColumnGroups).
//
// Bound on the H100: at the flagship shape (BH 64, S 128, Dh 392, bf16)
// the bytes (q, k, v, out once: 25.7 MB) bound it at ~7.7 us against
// ~1.7 us of bf16 tensor-core work. This first version does the products
// on the fp32 CUDA cores and runs far above that bound (PERF.md); the
// tensor-core (wgmma) and TMA version is later work.
#include "attention_fwd.cuh"

extern "C" {

// q, k, v, out: (batch_heads, seq_len, head_dim) contiguous, fp32 (is_bf16 0)
// or bf16 (is_bf16 1); lse: (batch_heads, seq_len) fp32; seed: (1,) int32 on
// the device, read only when dropout_rate > 0 (may be null otherwise).
// Returns the cudaError_t of the launch (0 on success); never synchronises.
int tchvp_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                    int batch_heads, int seq_len, int head_dim, int is_bf16,
                    float scale, float dropout_rate, unsigned int drop_threshold,
                    const void* seed, void* stream) {
  return tchvp::run_fwd(q, k, v, out, lse, batch_heads, seq_len, head_dim, is_bf16, scale,
      dropout_rate, drop_threshold, seed, stream);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
