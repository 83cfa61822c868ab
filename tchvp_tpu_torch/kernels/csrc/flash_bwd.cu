// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of tchvp_tpu/kernels/flash_attention.py
// driven by _flash_bwd: _dq_kernel (dq = sum_k ds k) and _dkv_kernel
// (dv = sum_q P_drop^T do, dk = sum_q ds^T q).
//
// Design: attention_bwd.cuh's two kernels with the band off, so the dq
// kernel's query tile walks every key and the dk/dv kernel's key tile every
// query row.
//
// Bound on the H100: at the training shape (BH 64, S 64, Dh 512, fp32) the
// bytes (q, k, v, do read and dq, dk, dv written once: 58.7 MB) bound the
// pair at ~17.5 us; the 10 BH S^2 Dh = 1.34 GFLOP of products take ~20 us at
// the 67 TFLOP/s fp32 CUDA-core peak, so operations bound it. This first
// version does its products on the fp32 CUDA cores from shared memory and
// runs far above that bound (PERF.md); a tensor-core (wgmma/TMA) version is
// later work.
#include "attention_bwd.cuh"

extern "C" {

// q, k, v, dout, dq: (batch_heads, seq_len, head_dim) contiguous, fp32
// (is_bf16 0) or bf16 (is_bf16 1); lse, delta: (batch_heads, seq_len) fp32;
// seed: (1,) int32 on the device, read only when dropout_rate > 0. Returns
// the cudaError_t of the launch (0 on success); never synchronises.
int tchvp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int batch_heads,
                       int seq_len, int head_dim, int is_bf16, float scale,
                       float dropout_rate, unsigned int drop_threshold, const void* seed,
                       void* stream) {
  return tchvp::run_bwd<tchvp::kFull>(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr,
      batch_heads, seq_len, head_dim, 0, is_bf16, scale, dropout_rate, drop_threshold, seed,
      stream);
}

// As tchvp_flash_bwd_dq, writing dk and dv (same shape and dtype as k, v).
int tchvp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv,
                        int batch_heads, int seq_len, int head_dim, int is_bf16, float scale,
                        float dropout_rate, unsigned int drop_threshold, const void* seed,
                        void* stream) {
  return tchvp::run_bwd<tchvp::kFull>(1, q, k, v, dout, lse, delta, nullptr, dk, dv,
      batch_heads, seq_len, head_dim, 0, is_bf16, scale, dropout_rate, drop_threshold, seed,
      stream);
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
