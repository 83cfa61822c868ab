// Fused decoder tail for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of tchvp_tpu/kernels/fused_tail.py:
// fused_decoder_tail:279 -> pallas_call:324 (_kernel:145). It computes
// Decoder32K.tail in eval mode with the BNs folded into the weights
// (fold_tail_params): x (B, H, W, 384) ->
//   u  = ReLU(ConvTranspose 2x2/s2 384->192)   at 2H x 2W
//   a0 = ReLU(conv3x3 192->64), a1 = ReLU(conv3x3 64->8)
//   out = ReLU or sigmoid(conv3x3 8->C4), C4 3 (image) or 1 (mask),
// every 3x3 conv SAME with zero padding at the image border. The input is
// read once and only the C4-channel output is written, in its final NHWC
// place; u, a0 and a1 never reach device memory.
//
// Bound on the H100 (3.35 TB/s; 989 TFLOP/s bf16 tensor cores; 67 TFLOP/s
// fp32 CUDA cores): operations. Per output pixel the tail needs 384*192
// (the ConvTranspose's 1x1 projection of its phase) + 9*(192*64 + 64*8 +
// 8*C4) multiply-adds, 189k, against 1.5 KB moved (bf16 input of 4 output
// pixels, output); config 1's call (128 x 112 x 112 x 384 bf16) is 2.43
// TFLOP, 2.46 ms on the tensor cores against 0.38 ms of bytes. This first
// version does its products on the fp32 CUDA cores (67 TFLOP/s) and runs
// far above that bound (PERF.md); a tensor-core version is later work.
//
// Design. One block of 256 threads per 16x16 output tile, any H, W >= 1
// (a partial edge tile masks its stores); output pixel (y, x) takes input
// pixel (y>>1, x>>1) through the weight columns of phase (y&1, x&1), and
// the image border is a bounds check on each stage's region. The tile
// needs a1 on 18^2, a0 on 20^2 and u on 22^2 pixels; u is computed per
// input pixel for all four phases, so on the 24^2 region of the tile's
// 12x12 input pixels (origin (Y0-4, X0-4)).
//  * Streamed channels: u is made 32 of its 192 channels at a time, as a
//    144 x 384 by 384 x 128 product (input pixels by the 4 phases x 32
//    channels of w_up), K staged through shared memory 32 input channels
//    at a time; each thread owns 9 pixels x 8 columns. Each chunk gets
//    bias, ReLU and the border, lands in shared memory (24^2 x 32) and is
//    added at once into conv0's accumulators, which live in registers for
//    the whole tile: each thread owns 4 of the 64 channels on a 5x5 pixel
//    patch of the 20^2 region, so a patch row of 7 u values feeds 3 taps x
//    5 pixels x 4 channels. Recomputed work: u on 576 and a0 on 400 pixels
//    for 256 outputs, 1.82x the tail's multiply-adds.
//  * conv1 and the head run from shared memory (a0 20^2 x 64, a1 18^2 x 8,
//    over the space of the chunk buffers) with one thread per pixel.
//  * Staging: the fp32 weights stream in by cp.async one K step ahead (two
//    w_up buffers; a chunk's conv0 weights ride with its second step), so
//    their L2 reads overlap the products; x (any dtype and strides) is read
//    by a plain loop. Each tile reads all of w_up and w0 (1.6 MB) from L2.
//  * Shared memory 198,656 bytes (one block of 8 warps per SM): x step
//    18.4 KB, w_up steps 2 x 16.4 KB, u chunk 73.7 KB, conv0 weights of the
//    chunk 73.7 KB. Registers: 255 per thread with ~300 bytes of spills
//    (build log); loading more at once spilled more and ran slower (PERF.md).
//  * fp32 CUDA-core FMAs and fp32 intermediates for both input types (the
//    TPU kernel rounds u, a0 and a1 to the input dtype; this one does not).
//    Weights arrive fp32, already rounded to the input dtype by the
//    wrapper as the TPU kernel casts them. Every output is summed by one
//    thread in one order, with no atomics: a repeat gives the same bits.
#include "flash_common.cuh"

namespace tchvp {
namespace tail {

constexpr int kCin = 384, kC1 = 192, kC2 = 64, kC3 = 8;
constexpr int kTile = 16;             // output tile, full resolution
constexpr int kIn = kTile / 2 + 4;    // 12 input rows / cols per tile
constexpr int kInPix = kIn * kIn;     // 144
constexpr int kU = 2 * kIn;           // 24: u region, origin (Y0-4, X0-4)
constexpr int kA0 = kTile + 4;        // 20: a0 region, origin (Y0-2, X0-2)
constexpr int kA1 = kTile + 2;        // 18: a1 region, origin (Y0-1, X0-1)
constexpr int kCC = 32;               // u channels per chunk
constexpr int kKC = 32;               // input channels per K step
constexpr int kThreads = 256;
constexpr int kPatch = 5;             // a0 patch per thread: 5x5 pixels x 4 channels
constexpr int kUPix = 9;              // u product: 9 input pixels x 8 columns per thread
static_assert(16 * kUPix == kInPix && (kA0 / kPatch) * (kA0 / kPatch) * 16 == kThreads, "roles");
static_assert(kTile * kTile == kThreads, "one head pixel per thread");
constexpr int kSteps = (kC1 / kCC) * (kCin / kKC);  // 72 K steps per tile
// 16-byte cp.async copies per thread: one K step's w_up slice, one chunk's w0.
constexpr int kWCopies = kKC * 4 * kCC / 4 / kThreads;  // 4
constexpr int kW0Copies = 9 * kCC * kC2 / 4 / kThreads;  // 18
static_assert(kWCopies * 4 * kThreads == kKC * 4 * kCC && kW0Copies * 4 * kThreads == 9 * kCC * kC2,
              "whole copy rounds");

// Shared memory, in floats. Phase A (u and conv0):
constexpr int kXsOff = 0;                              // [kKC][kInPix]
constexpr int kWsOff = kXsOff + kKC * kInPix;          // 2 x [kKC][4 * kCC], double buffer
constexpr int kUsOff = kWsOff + 2 * kKC * 4 * kCC;     // [kCC][kU * kU]
constexpr int kW0Off = kUsOff + kCC * kU * kU;         // [9][kCC][kC2]
constexpr int kPhaseA = kW0Off + 9 * kCC * kC2;
// Phase B (conv1 and the head), over the same space:
constexpr int kA0Off = 0;                              // [kC2][kA0 * kA0]
constexpr int kW1Off = kA0Off + kC2 * kA0 * kA0;       // [9][kC2][kC3]
constexpr int kA1Off = kW1Off + 9 * kC2 * kC3;         // [kC3][kA1 * kA1]
constexpr int kW2Off = kA1Off + kC3 * kA1 * kA1;       // [9][kC3][C4]
constexpr int kPhaseB = kW2Off + 9 * kC3 * 3;
constexpr size_t kSmemBytes = sizeof(float) * (kPhaseA > kPhaseB ? kPhaseA : kPhaseB);
static_assert(kWsOff % 4 == 0 && kUsOff % 4 == 0 && kW0Off % 4 == 0, "float4 alignment");
static_assert(kSmemBytes <= 232448, "one block's shared memory");

__device__ __forceinline__ bool inside(int y, int x, int rows, int cols) {
  return y >= 0 && y < rows && x >= 0 && x < cols;
}

// Asynchronous 16-byte copy global -> shared; completion is tracked per
// commit group (cp.async.wait_group), visibility to the block by a barrier.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// K step s's w_up slice: rows (s % 12)*kKC.., columns (phase, chunk s/12's channels).
__device__ __forceinline__ void stage_w_up(float* dst, const float* w_up, int s, int tid) {
  const int ch = s / (kCin / kKC), k0 = (s % (kCin / kKC)) * kKC;
#pragma unroll
  for (int it = 0; it < kWCopies; ++it) {
    const int q = tid + it * kThreads;  // 16-byte piece: 8 per (k, phase) row of kCC floats
    const int piece = q % (kCC / 4), ph = (q / (kCC / 4)) % 4, k = q / kCC;
    cp_async16(dst + k * 4 * kCC + ph * kCC + piece * 4,
               w_up + (k0 + k) * (4 * kC1) + ph * kC1 + ch * kCC + piece * 4);
  }
}

// Chunk ch's conv0 weights: w0[dy][dx][ch*kCC + c][:] -> dst[tap][c][:].
__device__ __forceinline__ void stage_w0(float* dst, const float* w0, int ch, int tid) {
#pragma unroll
  for (int it = 0; it < kW0Copies; ++it) {
    const int e = (tid + it * kThreads) * 4;
    const int o = e % kC2, c = (e / kC2) % kCC, tap = e / (kC2 * kCC);
    cp_async16(dst + e, w0 + (tap * kC1 + ch * kCC + c) * kC2 + o);
  }
}

template <typename T, int C4>
__global__ void __launch_bounds__(kThreads, 1)
fused_tail_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ w_up,
                  const float* __restrict__ b_up, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, int in_h, int in_w, int64_t sb, int64_t sh,
                  int64_t sw, int64_t sc, int tiles_y, int tiles_x, int sigmoid) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int64_t b = blockIdx.x / (tiles_x * tiles_y);
  const int rows = 2 * in_h, cols = 2 * in_w;  // output size
  const int y0 = ty * kTile, x0 = tx * kTile;
  const int iy0 = y0 / 2 - 2, ix0 = x0 / 2 - 2;  // the tile's first input pixel
  const T* xb = x + b * sb;

  float* xs = smem + kXsOff;
  float* ws = smem + kWsOff;
  float* us = smem + kUsOff;
  float* w0s = smem + kW0Off;

  // u product roles: input pixels pg*9.. and the 8 columns (phase, channel)
  // ng*4.. and 2*kCC + ng*4.. (phases ng/8 and 2 + ng/8, channels (ng%8)*4..),
  // so a quarter-warp's float4 weight loads fall on distinct banks.
  const int ng = tid & 15, pg = tid >> 4;
  // conv0 roles: channels cg*4.., the 5x5 patch at (ar0, ac0) of the a0 region
  const int cg = tid & 15;
  const int ar0 = ((tid >> 4) >> 2) * kPatch, ac0 = ((tid >> 4) & 3) * kPatch;

  float4 acc0[kPatch][kPatch];
#pragma unroll
  for (int r = 0; r < kPatch; ++r)
#pragma unroll
    for (int j = 0; j < kPatch; ++j) acc0[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  // The weights stream in by cp.async, one K step ahead: step s's w_up
  // slice lands in buffer s&1 while step s-1 computes from the other, and
  // a chunk's w0 travels with its second step's slice. x is read directly.
  stage_w_up(ws, w_up, 0, tid);
  cp_async_commit();
  for (int ch = 0; ch < kC1 / kCC; ++ch) {
    float accu[kUPix][8];
#pragma unroll
    for (int i = 0; i < kUPix; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) accu[i][j] = 0.f;

    for (int k0 = 0; k0 < kCin; k0 += kKC) {
      const int s = ch * (kCin / kKC) + k0 / kKC;
      // Every thread is done with step s-1 (xs, the other w_up buffer) and,
      // at a chunk's first step, with the last chunk's conv0 (us, w0s).
      __syncthreads();
      if (s + 1 < kSteps) stage_w_up(ws + ((s + 1) & 1) * kKC * 4 * kCC, w_up, s + 1, tid);
      if (k0 == 0) stage_w0(w0s, w0, ch, tid);
      cp_async_commit();
      for (int i = tid; i < kKC * kInPix; i += kThreads) {
        const int k = sc == 1 ? i % kKC : i / kInPix;
        const int p = sc == 1 ? i / kKC : i % kInPix;
        const int gy = iy0 + p / kIn, gx = ix0 + p % kIn;
        xs[k * kInPix + p] = inside(gy, gx, in_h, in_w)
                                 ? to_f32(xb[gy * sh + gx * sw + (k0 + k) * sc])
                                 : 0.f;
      }
      cp_async_wait<1>();  // all but this step's group: step s's slice (and w0 from step 1 on)
      __syncthreads();
      const float* wsb = ws + (s & 1) * kKC * 4 * kCC;
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float xv[kUPix];
#pragma unroll
        for (int i = 0; i < kUPix; ++i) xv[i] = xs[k * kInPix + pg * kUPix + i];
        const float4 wa = *reinterpret_cast<const float4*>(wsb + k * 4 * kCC + ng * 4);
        const float4 wb = *reinterpret_cast<const float4*>(wsb + k * 4 * kCC + 2 * kCC + ng * 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < kUPix; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) accu[i][j] = fmaf(xv[i], wv[j], accu[i][j]);
      }
    }

    // u of this chunk: bias, ReLU, and zero outside the image (conv0's padding).
#pragma unroll
    for (int i = 0; i < kUPix; ++i) {
      const int p = pg * kUPix + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ph = (ng >> 3) + 2 * (j >> 2), cu = (ng & 7) * 4 + (j & 3);
        const int r = 2 * (p / kIn) + (ph >> 1), c = 2 * (p % kIn) + (ph & 1);
        us[cu * kU * kU + r * kU + c] = inside(y0 - 4 + r, x0 - 4 + c, rows, cols)
                                            ? fmaxf(accu[i][j] + b_up[ch * kCC + cu], 0.f)
                                            : 0.f;
      }
    }
    __syncthreads();  // us written; w0s landed at the chunk's second step

    // conv0 partial sums over the chunk's channels. Patch pixel (r, j) at tap
    // (dy, dx) reads u at (ar0 + r + dy + 1, ac0 + j + dx + 1).
    for (int c = 0; c < kCC; ++c) {
      float4 wt[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        wt[tap] = *reinterpret_cast<const float4*>(w0s + (tap * kCC + c) * kC2 + cg * 4);
      const float* uc = us + c * kU * kU + (ar0 + 1) * kU + ac0 + 1;
#pragma unroll
      for (int ur = 0; ur < kPatch + 2; ++ur) {
        float uv[kPatch + 2];
#pragma unroll
        for (int q = 0; q < kPatch + 2; ++q) uv[q] = uc[ur * kU + q];
#pragma unroll
        for (int r = 0; r < kPatch; ++r) {
          const int dy = ur - r;
          if (dy < 0 || dy > 2) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 w = wt[dy * 3 + dx];
#pragma unroll
            for (int j = 0; j < kPatch; ++j) {
              const float u = uv[j + dx];
              acc0[r][j].x = fmaf(u, w.x, acc0[r][j].x);
              acc0[r][j].y = fmaf(u, w.y, acc0[r][j].y);
              acc0[r][j].z = fmaf(u, w.z, acc0[r][j].z);
              acc0[r][j].w = fmaf(u, w.w, acc0[r][j].w);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // phase A's shared memory is free

  float* a0s = smem + kA0Off;
  float* w1s = smem + kW1Off;
  float* a1s = smem + kA1Off;
  float* w2s = smem + kW2Off;
  {
    const float4 bias = make_float4(b0[cg * 4], b0[cg * 4 + 1], b0[cg * 4 + 2], b0[cg * 4 + 3]);
#pragma unroll
    for (int r = 0; r < kPatch; ++r)
#pragma unroll
      for (int j = 0; j < kPatch; ++j) {
        const int i = ar0 + r, jj = ac0 + j;
        const bool in = inside(y0 - 2 + i, x0 - 2 + jj, rows, cols);
        float* dst = a0s + (cg * 4) * kA0 * kA0 + i * kA0 + jj;
        dst[0] = in ? fmaxf(acc0[r][j].x + bias.x, 0.f) : 0.f;
        dst[kA0 * kA0] = in ? fmaxf(acc0[r][j].y + bias.y, 0.f) : 0.f;
        dst[2 * kA0 * kA0] = in ? fmaxf(acc0[r][j].z + bias.z, 0.f) : 0.f;
        dst[3 * kA0 * kA0] = in ? fmaxf(acc0[r][j].w + bias.w, 0.f) : 0.f;
      }
  }
  for (int i = tid; i < 9 * kC2 * kC3; i += kThreads) w1s[i] = w1[i];
  for (int i = tid; i < 9 * kC3 * C4; i += kThreads) w2s[i] = w2[i];
  __syncthreads();

  // conv1 on the 18^2 region: a1 pixel (i, j) at tap (dy, dx) reads a0 (i + dy, j + dx).
  for (int p = tid; p < kA1 * kA1; p += kThreads) {
    const int i = p / kA1, j = p % kA1;
    float acc[kC3];
#pragma unroll
    for (int o = 0; o < kC3; ++o) acc[o] = 0.f;
    for (int c = 0; c < kC2; ++c) {
      const float* a = a0s + c * kA0 * kA0 + i * kA0 + j;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = a[(tap / 3) * kA0 + tap % 3];
        const float* w = w1s + (tap * kC2 + c) * kC3;
#pragma unroll
        for (int o = 0; o < kC3; ++o) acc[o] = fmaf(v, w[o], acc[o]);
      }
    }
    const bool in = inside(y0 - 1 + i, x0 - 1 + j, rows, cols);
#pragma unroll
    for (int o = 0; o < kC3; ++o) a1s[o * kA1 * kA1 + p] = in ? fmaxf(acc[o] + b1[o], 0.f) : 0.f;
  }
  __syncthreads();

  // The head: one output pixel per thread, written in its NHWC place.
  const int i = tid / kTile, j = tid % kTile;
  const int gy = y0 + i, gx = x0 + j;
  if (gy < rows && gx < cols) {
    float acc[C4];
#pragma unroll
    for (int o = 0; o < C4; ++o) acc[o] = 0.f;
#pragma unroll
    for (int c = 0; c < kC3; ++c)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = a1s[c * kA1 * kA1 + (i + tap / 3) * kA1 + j + tap % 3];
#pragma unroll
        for (int o = 0; o < C4; ++o) acc[o] = fmaf(v, w2s[(tap * kC3 + c) * C4 + o], acc[o]);
      }
    T* dst = out + ((b * rows + gy) * cols + gx) * C4;
#pragma unroll
    for (int o = 0; o < C4; ++o) {
      const float v = acc[o] + b2[o];
      dst[o] = from_f32<T>(sigmoid ? 1.f / (1.f + expf(-v)) : fmaxf(v, 0.f));
    }
  }
}

template <typename T, int C4>
int launch(const void* x, void* out, const float* const* w, int64_t batch, int64_t in_h,
           int64_t in_w, int64_t sb, int64_t sh, int64_t sw, int64_t sc, int sigmoid,
           cudaStream_t stream) {
  const int64_t tiles_y = (2 * in_h + kTile - 1) / kTile, tiles_x = (2 * in_w + kTile - 1) / kTile;
  const int64_t blocks = batch * tiles_y * tiles_x;
  if (blocks > 0x7fffffff || in_h > (1 << 28) || in_w > (1 << 28)) return cudaErrorInvalidValue;
  auto kernel = fused_tail_kernel<T, C4>;
  const cudaError_t err = allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), w[0], w[1], w[2], w[3], w[4], w[5], w[6],
      w[7], (int)in_h, (int)in_w, sb, sh, sw, sc, (int)tiles_y, (int)tiles_x, sigmoid);
  return cudaGetLastError();
}

}  // namespace tail
}  // namespace tchvp

extern "C" {

// x: (batch, in_h, in_w, 384) fp32 (is_bf16 0) or bf16 (is_bf16 1) with
// element strides sb, sh, sw, sc; out: (batch, 2 in_h, 2 in_w, c4)
// contiguous, x's dtype. The weights are fp32, contiguous and 16-byte
// aligned, in the layouts of fold_tail_params: w_up (384, 768) with columns (di, dj, c),
// b_up (192), w0 (3, 3, 192, 64), b0 (64), w1 (3, 3, 64, 8), b1 (8), w2
// (3, 3, 8, c4), b2 (c4); c4 is 3 or 1, sigmoid 1 for the mask head.
// Returns the cudaError_t of the launch (0 on success); never synchronises.
int tchvp_fused_tail(const void* x, void* out, const void* w_up, const void* b_up,
                     const void* w0, const void* b0, const void* w1, const void* b1,
                     const void* w2, const void* b2, int64_t batch, int64_t in_h, int64_t in_w,
                     int64_t sb, int64_t sh, int64_t sw, int64_t sc, int c4, int sigmoid,
                     int is_bf16, void* stream) {
  using tchvp::tail::launch;
  const float* w[8] = {static_cast<const float*>(w_up), static_cast<const float*>(b_up),
                       static_cast<const float*>(w0),   static_cast<const float*>(b0),
                       static_cast<const float*>(w1),   static_cast<const float*>(b1),
                       static_cast<const float*>(w2),   static_cast<const float*>(b2)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c4 == 3)
    return is_bf16 ? launch<__nv_bfloat16, 3>(x, out, w, batch, in_h, in_w, sb, sh, sw, sc, sigmoid, s)
                   : launch<float, 3>(x, out, w, batch, in_h, in_w, sb, sh, sw, sc, sigmoid, s);
  if (c4 == 1)
    return is_bf16 ? launch<__nv_bfloat16, 1>(x, out, w, batch, in_h, in_w, sb, sh, sw, sc, sigmoid, s)
                   : launch<float, 1>(x, out, w, batch, in_h, in_w, sb, sh, sw, sc, sigmoid, s);
  return cudaErrorInvalidValue;
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
