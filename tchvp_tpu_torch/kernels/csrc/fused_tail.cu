// Fused decoder tail for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes.
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
// Bound on the H100 (3.35 TB/s; 989 TFLOP/s bf16 tensor cores): operations.
// Per output pixel the tail needs 384*192 (the ConvTranspose's 1x1
// projection of its phase) + 9*(192*64 + 64*8 + 8*C4) multiply-adds, 189k,
// against 1.5 KB moved (bf16 input of 4 output pixels, output); config 1's
// call (128 x 112 x 112 x 384 bf16) is 2.43 TFLOP, 2.46 ms on the tensor
// cores against 0.38 ms of bytes.
//
// Design. One block of 12 warps per 16x16 output tile, any H, W >= 1 (a
// partial edge tile masks its stores); output pixel (y, x) takes input pixel
// (y>>1, x>>1) through the weight columns of phase (y&1, x&1), and the image
// border is a bounds check on each stage's region. The tile needs a1 on 18^2,
// a0 on 20^2 and u on 22^2 pixels; u is computed per input pixel for all four
// phases, so on the 24^2 region of the tile's 12x12 input pixels (origin
// (Y0-4, X0-4)). Recomputed work: u on 576 and a0 on 400 pixels for 256
// outputs, 1.82x the tail's multiply-adds. Every product is an mma.sync
// (mma_common.cuh): bf16 m16n8k16, or m16n8k8 tf32 as 3xTF32 for fp32.
//  * u, 32 of its 192 channels at a time (a chunk): a GEMM of the 144 input
//    pixels (9 m16 tiles) by the 4 phases x 32 channels of w_up, K the 384
//    input channels. Warp w owns m16 tiles 3 (w / 4)..+2 and phase w % 4's
//    32 columns: 48 accumulators a thread. The epilogue adds the bias,
//    applies ReLU and the border and stores the chunk, rounded to the input
//    dtype, to shared memory (24^2 x 32).
//  * conv0 as an implicit GEMM over the chunk: rows the 400 a0 pixels (25 m16
//    tiles), K 9 taps x 32 channels, N 64. ldmatrix takes one row address
//    per lane, so a tap is a shifted row of the u chunk: no im2col buffer.
//    Its accumulators stay in registers across the six chunks: warp w owns
//    m16 tiles 2w, 2w+1 with all 8 n8 tiles and, for w < 8, m16 tile 24 with
//    n8 tile w (68 a thread).
//  * conv1 (K 9 x 64, N 8) on mma.sync from a0 in shared memory, 21 m16 tiles
//    over the 18^2 a1 pixels; the head (8 -> C4, 0.1 % of the work) on the
//    CUDA cores from a1 in shared memory.
//  * Each warp loads the next A fragment before the current one's products.
//    168 registers a thread (12 warps), no spills in bf16 (build log).
//  * Staging: a ring of 4 stages of 64 bytes of K each, filled by cp.async 3
//    stages ahead: per chunk 384 / K-stage steps of w_up rows (the packed
//    w_up is (4 x 192, 384), K contiguous, so B fragments load by ldmatrix
//    without a transpose) and 9 x 32 / K-stage steps of w0 rows ((9, 64,
//    192)). Each tile reads all of w_up and w0 from L2 (811 KB in bf16). In
//    bf16 the whole x tile (144 x 384) stays in shared memory, staged with
//    the first stage; in fp32 it streams with w_up, one K stage per step.
//    x is staged under three layouts, chosen by the launcher from its
//    strides: channels contiguous and 16-byte aligned (16-byte cp.async into
//    a pixel-major tile, ldmatrix), pixels contiguous in pairs as in the NHWC
//    view of an NCHW tensor (bf16: 4-byte cp.async into a channel-major
//    tile, ldmatrix.trans), or element loads. All three give the same A
//    fragments, so the same bits.
//  * Shared memory: bf16 203,776 bytes (x 116,736, u chunk 46,080, ring
//    40,960), fp32 169,984; a0, w1 and a1 reuse it after the last chunk.
//    Rows are padded by 16 bytes so the 8 rows of an ldmatrix fall on
//    distinct bank groups.
//  * Numerics: u is stored in the input dtype, the A operand of conv0 (the
//    TPU kernel stores u, a0 and a1 so, fused_tail.py:19-21); a0 and a1 stay
//    fp32, and in bf16 conv1 takes a0 as two bf16 parts (hi + lo, two
//    products). With all three rounded, the decoder path of config 1 read
//    2.45e-2 x max|ref| from the fp32 chain on an NVIDIA H100 80GB HBM3
//    (700 W), over its 2e-2 limit; with u alone 1.61e-2 (PERF.md,
//    fused_tail_breakdown.py --rounding). Sums are
//    fp32. Every output is summed by one thread or one mma chain in one
//    order, with no atomics: a repeat gives the same bits.
//
// What bounds it (PERF.md): the shared-memory reads of the ldmatrix
// fragments, about as long as the products and not overlapped with them;
// wgmma, which reads its operands from shared memory itself, is the next
// step.
#include "mma_common.cuh"

namespace tchvp {
namespace tail {

constexpr int kCin = 384, kC1 = 192, kC2 = 64, kC3 = 8;
constexpr int kTile = 16;             // output tile, full resolution
constexpr int kIn = kTile / 2 + 4;    // 12 input rows / cols per tile
constexpr int kInPix = kIn * kIn;     // 144: 9 m16 tiles
constexpr int kU = 2 * kIn;           // 24: u region, origin (Y0-4, X0-4)
constexpr int kA0 = kTile + 4;        // 20: a0 region, origin (Y0-2, X0-2)
constexpr int kA0Pix = kA0 * kA0;     // 400: 25 m16 tiles
constexpr int kA1 = kTile + 2;        // 18: a1 region, origin (Y0-1, X0-1)
constexpr int kA1Pix = kA1 * kA1;     // 324: 21 m16 tiles, the last one partly
constexpr int kA1Tiles = (kA1Pix + 15) / 16;
constexpr int kCC = 32;               // u channels per chunk
constexpr int kChunks = kC1 / kCC;
constexpr int kThreads = 384;          // 12 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 4;              // cp.async stages
static_assert(kInPix == 9 * 16 && kA0Pix == 25 * 16 && kWarps == 12 && kTile * kTile <= kThreads, "roles");

// Sizes in elements of T. A stage carries 64 bytes of K (two mma k-steps of
// 32 bytes: k16 in bf16, k8 in fp32); rows are padded by 16 bytes.
template <typename T>
struct Cfg {
  static constexpr int kE = sizeof(T);
  static constexpr int kPad = 16 / kE;              // one 16-byte piece
  static constexpr int kKS = 64 / kE;               // K per stage: 32 | 16
  static constexpr int kSlotLd = kKS + kPad;        // 80-byte rows
  static constexpr int kUStages = kCin / kKS;       // per chunk: 12 | 24
  static constexpr int kC0Stages = 9 * kCC / kKS;   // per chunk: 9 | 18
  static constexpr int kStages = kUStages + kC0Stages;
  static constexpr int kTotal = kChunks * kStages;
  static constexpr bool kXResident = kE == 2;       // the whole x tile in shared memory
  static constexpr int kXLd = kCin + kPad;          // resident, pixel-major
  static constexpr int kXLdT = kInPix + kPad;       // resident, channel-major
  static constexpr int kXElems =
      kXResident ? (kInPix * kXLd > kCin * kXLdT ? kInPix * kXLd : kCin * kXLdT) : 0;
  static constexpr int kULd = kCC + kPad;
  static constexpr int kUOff = kXElems;
  static constexpr int kRingOff = kUOff + kU * kU * kULd;
  static constexpr int kSlotX = kXResident ? 0 : kInPix * kSlotLd;  // streamed x, pixel-major
  static constexpr int kSlot = kSlotX + 4 * kCC * kSlotLd;          // then w_up's 128 rows (w0: 64)
  static constexpr int kPhaseA = kRingOff + kRing * kSlot;
  // After the last chunk, in bytes: a0 [400][kA0Ld] fp32, w1 [8][kW1Ld] in T,
  // a1 [324][8] fp32. a0's rows: 68 floats for ldmatrix (fp32), 72 for the
  // 8-byte loads of the bf16 split, each conflict-free.
  static constexpr int kA0Ld = kE == 2 ? kC2 + 8 : kC2 + 4;
  static constexpr int kW1Ld = 9 * kC2 + kPad;
  static constexpr int kW1Off = kA0Pix * kA0Ld * 4;
  static constexpr int kA1Off = kW1Off + kC3 * kW1Ld * kE;
  static constexpr int kPhaseB = kA1Off + kA1Pix * kC3 * 4;
  static constexpr size_t kSmemBytes = size_t(kE) * kPhaseA > kPhaseB ? size_t(kE) * kPhaseA : kPhaseB;
  static_assert(kSmemBytes <= 232448, "one block's shared memory");
  static_assert((kUOff * kE) % 16 == 0 && (kRingOff * kE) % 16 == 0 && (kSlot * kE) % 16 == 0 &&
                    (kSlotX * kE) % 16 == 0 && kW1Off % 16 == 0 && kA1Off % 16 == 0,
                "16-byte aligned regions");
};

struct Args {
  const void* x;
  void* out;
  const void* w_up;    // (4 * 192, 384), x's dtype
  const float* b_up;   // (192)
  const void* w0;      // (9, 64, 192), x's dtype
  const float* b0;     // (64)
  const void* w1;      // (8, 9 * 64), x's dtype
  const float* b1;     // (8)
  const float* w2;     // (3, 3, 8, C4)
  const float* b2;     // (C4)
  int in_h, in_w;
  int64_t sb, sh, sw, sc;
  int tiles_y, tiles_x, sigmoid;
  int xmode;  // 1: 16-byte pieces of channels; 2: pairs of pixels (bf16); 0: elements
};

__device__ __forceinline__ bool inside(int y, int x, int rows, int cols) {
  return y >= 0 && y < rows && x >= 0 && x < cols;
}

// 4 bytes global -> shared, zero-filled when bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// One mma k-step's fragment of N registers: in bf16 the registers ldmatrix
// gives; in fp32 each split into tf32 halves for 3xTF32.
template <typename T, int N>
struct Frag {
  uint32_t r[N];
};
template <int N>
struct Frag<float, N> {
  uint32_t hi[N], lo[N];
};

template <typename T, int N>
__device__ __forceinline__ void set_frag(Frag<T, N>& f, const uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(T) == 2) {
      f.r[i] = r[i];
    } else {
      split_tf32(__uint_as_float(r[i]), &f.hi[i], &f.lo[i]);
    }
  }
}

// A of a 16-row k-step: lane l gives row l & 15 at byte offset 16 (l >> 4).
template <typename T>
__device__ __forceinline__ void load_a(Frag<T, 4>& f, const T* p) {
  uint32_t r[4];
  ldmatrix_x4(r, p);
  set_frag(f, r);
}

// The same A from a channel-major tile (bf16): lane l gives channel row
// 8 ((l >> 4) & 1) + (l & 7) at pixel column 8 ((l >> 3) & 1).
template <typename T>
__device__ __forceinline__ void load_a_trans(Frag<T, 4>& f, const T* p) {
  uint32_t r[4];
  ldmatrix_x4_trans(r, p);
  set_frag(f, r);
}

// Two B fragments from rows of K-contiguous weights: (n 0-7 | 8-15, one
// k-step), or (n 0-7, two k-steps), as the lanes' addresses say.
template <typename T>
__device__ __forceinline__ void load_b2(Frag<T, 2>& f0, Frag<T, 2>& f1, const T* p) {
  uint32_t r[4];
  ldmatrix_x4(r, p);
  set_frag(f0, r);
  set_frag(f1, r + 2);
}

// A of a bf16 k-step from fp32 rows as two bf16 parts, hi = bf16(a) and lo =
// bf16(a - hi): r0 and r8 point at rows g and g + 8, column 2t.
template <typename T>
__device__ __forceinline__ void load_a_split(Frag<T, 4>& hi, Frag<T, 4>& lo, const float* r0, const float* r8) {
  const float* at[4] = {r0, r8, r0 + 8, r8 + 8};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = *reinterpret_cast<const float2*>(at[i]);
    const float hx = __bfloat162float(__float2bfloat16(v.x)), hy = __bfloat162float(__float2bfloat16(v.y));
    hi.r[i] = pack_bf16(hx, hy);
    lo.r[i] = pack_bf16(v.x - hx, v.y - hy);
  }
}

template <typename T>
__device__ __forceinline__ void mma(float* c, const Frag<T, 4>& a, const Frag<T, 2>& b) {
  if constexpr (sizeof(T) == 2) {
    mma_bf16(c, a.r, b.r);
  } else {  // 3xTF32, the small products first
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float lo, float hi) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
  }
}

// K stage s of the x tile (input channels s * kKS..) into dst: the resident
// tile (bf16) or a ring slot (fp32). Outside the image it reads 0.
template <typename T>
__device__ __forceinline__ void stage_x(T* dst, int s, const T* xb, const Args& p, int iy0, int ix0,
                                        int tid) {
  using C = Cfg<T>;
  const int col0 = C::kXResident ? s * C::kKS : 0;
  const int ld = C::kXResident ? C::kXLd : C::kSlotLd;
  if (p.xmode == 1) {  // channels contiguous: 4 pieces of 16 bytes per pixel
    for (int i = tid; i < kInPix * 4; i += kThreads) {
      const int px = i >> 2, piece = i & 3;
      const int gy = iy0 + px / kIn, gx = ix0 + px % kIn;
      const bool in = inside(gy, gx, p.in_h, p.in_w);
      const T* src = in ? xb + gy * p.sh + gx * p.sw + s * C::kKS + piece * C::kPad : xb;
      cp_async16(dst + px * ld + col0 + piece * C::kPad, src, in ? 16 : 0);
    }
  } else if (C::kXResident && p.xmode == 2) {  // pixel pairs, channel-major tile
    for (int i = tid; i < C::kKS * kIn * (kIn / 2); i += kThreads) {
      const int pair = i % (kIn / 2), r = (i / (kIn / 2)) % kIn, k = s * C::kKS + i / (kIn * kIn / 2);
      const int gy = iy0 + r, gx = ix0 + 2 * pair;  // even, and in_w is even: both pixels or neither
      const bool in = inside(gy, gx, p.in_h, p.in_w);
      const T* src = in ? xb + k * p.sc + gy * p.sh + gx : xb;
      cp_async4(dst + k * C::kXLdT + r * kIn + 2 * pair, src, in ? 4 : 0);
    }
  } else {  // any strides: element loads
    for (int i = tid; i < kInPix * C::kKS; i += kThreads) {
      const int k = i % C::kKS, px = i / C::kKS;
      const int gy = iy0 + px / kIn, gx = ix0 + px % kIn;
      dst[px * ld + col0 + k] = inside(gy, gx, p.in_h, p.in_w)
                                    ? xb[gy * p.sh + gx * p.sw + (s * C::kKS + k) * p.sc]
                                    : from_f32<T>(0.f);
    }
  }
}

template <typename T, int C4>
__global__ void __launch_bounds__(kThreads, 1) fused_tail_kernel(const Args p) {
  using C = Cfg<T>;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tx = blockIdx.x % p.tiles_x;
  const int ty = (blockIdx.x / p.tiles_x) % p.tiles_y;
  const int64_t b = blockIdx.x / (p.tiles_x * p.tiles_y);
  const int rows = 2 * p.in_h, cols = 2 * p.in_w;  // output size
  const int y0 = ty * kTile, x0 = tx * kTile;
  const int iy0 = y0 / 2 - 2, ix0 = x0 / 2 - 2;  // the tile's first input pixel
  const T* xb = static_cast<const T*>(p.x) + b * p.sb;
  const T* w_up = static_cast<const T*>(p.w_up);
  const T* w0 = static_cast<const T*>(p.w0);
  T* xs = smem;
  T* us = smem + C::kUOff;
  T* ring = smem + C::kRingOff;

  // Stage j of the tile's sequence (per chunk: the u stages, then conv0's)
  // into ring slot j % kRing.
  auto issue = [&](int j) {
    T* slot = ring + (j % kRing) * C::kSlot;
    T* wb = slot + C::kSlotX;
    const int ch = j / C::kStages, s = j % C::kStages;
    if (s < C::kUStages) {
      if (!C::kXResident) stage_x<T>(slot, s, xb, p, iy0, ix0, tid);
      for (int i = tid; i < 4 * kCC * 4; i += kThreads) {  // 128 rows (phase, channel) x 4 pieces
        const int r = i >> 2, piece = i & 3;
        const int n = (r / kCC) * kC1 + ch * kCC + r % kCC;
        cp_async16(wb + r * C::kSlotLd + piece * C::kPad,
                   w_up + (size_t)n * kCin + s * C::kKS + piece * C::kPad, 16);
      }
    } else {
      const int c = s - C::kUStages, tap = c / (kCC / C::kKS), half = c % (kCC / C::kKS);
      const int o = tid >> 2, piece = tid & 3;  // 64 rows x 4 pieces
      if (tid < 4 * kC2) cp_async16(wb + o * C::kSlotLd + piece * C::kPad,
                 w0 + ((size_t)tap * kC2 + o) * kC1 + ch * kCC + half * C::kKS + piece * C::kPad, 16);
    }
  };
  // Every thread is done with stage j - 1 (whose slot stage j + kRing - 1
  // takes), and stage j has landed.
  auto advance = [&](int j) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (j + kRing - 1 < C::kTotal) issue(j + kRing - 1);
    cp_async_commit();
  };

  // u roles: m16 tiles mt0..mt0 + 2 of the input pixels, phase ph's 32 columns.
  const int ph = warp & 3, mt0 = 3 * (warp >> 2);
  // conv0 roles: m16 tiles 2 warp, 2 warp + 1 (all 8 n8 tiles) and, for the
  // first 8 warps, 24 (n8 tile warp); ubase: the u row of each lane's a0
  // pixel at tap (0, 0).
  const bool extra = warp < 8;
  int ubase[3];
#pragma unroll
  for (int mi = 0; mi < 3; ++mi) {
    const int m = (mi < 2 ? 2 * warp + mi : 24) * 16 + (lane & 15);
    ubase[mi] = (m / kA0 + 1) * kU + m % kA0 + 1;
  }
  float acc0[2][8][4], accx[4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc0[mi][ni][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) accx[e] = 0.f;

  // The resident x tile travels with the first stage.
  if (C::kXResident)
    for (int s = 0; s < C::kUStages; ++s) stage_x<T>(xs, s, xb, p, iy0, ix0, tid);
#pragma unroll
  for (int j = 0; j < kRing - 1; ++j) {
    issue(j);
    cp_async_commit();
  }
  int j = 0;
  for (int ch = 0; ch < kChunks; ++ch) {
    float accu[3][4][4];
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) accu[mi][ni][e] = 0.f;

    for (int s = 0; s < C::kUStages; ++s, ++j) {
      advance(j);
      const T* wb = ring + (j % kRing) * C::kSlot + C::kSlotX;
      const T* xt = C::kXResident ? xs : ring + (j % kRing) * C::kSlot;
      const int xld = C::kXResident ? C::kXLd : C::kSlotLd, xcol = C::kXResident ? s * C::kKS : 0;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        Frag<T, 2> bf[4];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          load_b2(bf[2 * nb], bf[2 * nb + 1],
                  wb + (ph * kCC + nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * C::kSlotLd +
                      2 * kk * C::kPad + ((lane >> 3) & 1) * C::kPad);
        // A of m16 tile mt0 + mi; the next tile's loads before this one's products.
        auto load_x = [&](Frag<T, 4>& af, int mi) {
          const int mt = mt0 + mi;
          if (C::kXResident && p.xmode == 2)
            load_a_trans(af, xs + (s * C::kKS + 2 * kk * C::kPad + ((lane >> 4) << 3) + (lane & 7)) * C::kXLdT +
                                 mt * 16 + (lane & 8));
          else
            load_a(af, xt + (mt * 16 + (lane & 15)) * xld + xcol + 2 * kk * C::kPad + (lane >> 4) * C::kPad);
        };
        Frag<T, 4> af[2];
        load_x(af[0], 0);
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) {
          if (mi + 1 < 3) load_x(af[(mi + 1) & 1], mi + 1);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma<T>(accu[mi][ni], af[mi & 1], bf[ni]);
        }
      }
    }

    // u of this chunk: bias, ReLU, zero outside the image (conv0's padding),
    // rounded to T. Every warp is past the last conv0 stage that read us.
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float bias0 = p.b_up[ch * kCC + ni * 8 + 2 * t], bias1 = p.b_up[ch * kCC + ni * 8 + 2 * t + 1];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = (mt0 + mi) * 16 + g + 8 * h;
          const int r = 2 * (px / kIn) + (ph >> 1), c = 2 * (px % kIn) + (ph & 1);
          const bool in = inside(y0 - 4 + r, x0 - 4 + c, rows, cols);
          store_pair(us + (r * kU + c) * C::kULd + ni * 8 + 2 * t,
                     in ? fmaxf(accu[mi][ni][2 * h] + bias0, 0.f) : 0.f,
                     in ? fmaxf(accu[mi][ni][2 * h + 1] + bias1, 0.f) : 0.f);
        }
      }
    }

    for (int c = 0; c < C::kC0Stages; ++c, ++j) {
      advance(j);
      const T* wb = ring + (j % kRing) * C::kSlot + C::kSlotX;
      const int tap = c / (kCC / C::kKS), half = c % (kCC / C::kKS);
      const int shift = (tap / 3) * kU + tap % 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        Frag<T, 2> bf[8];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          load_b2(bf[2 * nb], bf[2 * nb + 1],
                  wb + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * C::kSlotLd + 2 * kk * C::kPad +
                      ((lane >> 3) & 1) * C::kPad);
        const int col = half * C::kKS + 2 * kk * C::kPad + (lane >> 4) * C::kPad;
        Frag<T, 4> af[2];
        load_a(af[0], us + (ubase[0] + shift) * C::kULd + col);
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) {
          if (mi < 2) {
            if (mi == 0 || extra) load_a(af[(mi + 1) & 1], us + (ubase[mi + 1] + shift) * C::kULd + col);
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) mma<T>(acc0[mi][ni], af[mi & 1], bf[ni]);
          } else if (extra) {
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
              if (ni == warp) mma<T>(accx, af[mi & 1], bf[ni]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // phase A's shared memory is free

  float* a0s = reinterpret_cast<float*>(smem4);
  T* w1s = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + C::kW1Off);
  float* a1s = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + C::kA1Off);
  {
    const T* w1 = static_cast<const T*>(p.w1);
    constexpr int kPieces = 9 * kC2 / C::kPad;  // per row of w1
    for (int i = tid; i < kC3 * kPieces; i += kThreads)
      cp_async16(w1s + (i / kPieces) * C::kW1Ld + (i % kPieces) * C::kPad, w1 + i * C::kPad, 16);
    cp_async_commit();
  }
  // a0: bias, ReLU, zero outside the image (conv1's padding), fp32.
  auto store_a0 = [&](const float* acc, int mt, int ni) {
    const int o = ni * 8 + 2 * t;
    const float bias0 = p.b0[o], bias1 = p.b0[o + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * 16 + g + 8 * h;
      const bool in = inside(y0 - 2 + m / kA0, x0 - 2 + m % kA0, rows, cols);
      store_pair(a0s + m * C::kA0Ld + o, in ? fmaxf(acc[2 * h] + bias0, 0.f) : 0.f,
                 in ? fmaxf(acc[2 * h + 1] + bias1, 0.f) : 0.f);
    }
  };
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) store_a0(acc0[mi][ni], 2 * warp + mi, ni);
  if (extra) store_a0(accx, 24, warp);
  cp_async_wait<0>();
  __syncthreads();

  // conv1: m16 tiles warp and warp + 12 of the a1 pixels; a1 pixel
  // (i, j) at tap (dy, dx) reads a0 (i + dy, j + dx). Rows past 324 read a
  // valid pixel and are dropped.
  {
    const int n1 = warp + kWarps < kA1Tiles ? 2 : 1;
    // Each lane's a0 rows at tap (0, 0): for ldmatrix (fp32) the row of
    // lane & 15 (hh 0); for the bf16 split the rows of g and g + 8.
    int abase[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = sizeof(T) == 2 ? g + 8 * hh : (lane & 15);
        const int m = min((warp + kWarps * mi) * 16 + r, kA1Pix - 1);
        abase[mi][hh] = (m / kA1) * kA0 + m % kA1;
      }
    float acc1[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[mi][e] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * kA0 + tap % 3;
#pragma unroll
      for (int kp = 0; kp < kC2 / C::kKS; ++kp) {  // pairs of k-steps: 64 bytes of w1's K each
        Frag<T, 2> bk[2];
        load_b2(bk[0], bk[1], w1s + (lane & 7) * C::kW1Ld + tap * kC2 + kp * C::kKS + (lane >> 3) * C::kPad);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (mi < n1) {
              if constexpr (sizeof(T) == 2) {  // a0 as hi + lo bf16 parts: two products
                const int col = kp * C::kKS + 16 * ks + 2 * t;
                Frag<T, 4> hi, lo;
                load_a_split(hi, lo, a0s + (abase[mi][0] + shift) * C::kA0Ld + col,
                             a0s + (abase[mi][1] + shift) * C::kA0Ld + col);
                mma<T>(acc1[mi], lo, bk[ks]);
                mma<T>(acc1[mi], hi, bk[ks]);
              } else {
                Frag<T, 4> af;
                load_a(af, a0s + (abase[mi][0] + shift) * C::kA0Ld + kp * C::kKS + 2 * ks * C::kPad +
                               (lane >> 4) * C::kPad);
                mma<T>(acc1[mi], af, bk[ks]);
              }
            }
          }
      }
    }
    const float bias0 = p.b1[2 * t], bias1 = p.b1[2 * t + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (mi < n1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (warp + kWarps * mi) * 16 + g + 8 * h;
          if (m < kA1Pix) {
            const bool in = inside(y0 - 1 + m / kA1, x0 - 1 + m % kA1, rows, cols);
            store_pair(a1s + m * kC3 + 2 * t, in ? fmaxf(acc1[mi][2 * h] + bias0, 0.f) : 0.f,
                       in ? fmaxf(acc1[mi][2 * h + 1] + bias1, 0.f) : 0.f);
          }
        }
      }
    }
  }
  __syncthreads();

  // The head: one output pixel per thread, written in its NHWC place.
  const int i = tid / kTile, jj = tid % kTile;
  const int gy = y0 + i, gx = x0 + jj;
  if (tid < kTile * kTile && gy < rows && gx < cols) {
    float acc[C4];
#pragma unroll
    for (int o = 0; o < C4; ++o) acc[o] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int c = 0; c < kC3; ++c) {
        const float v = a1s[((i + tap / 3) * kA1 + jj + tap % 3) * kC3 + c];
#pragma unroll
        for (int o = 0; o < C4; ++o) acc[o] = fmaf(v, __ldg(p.w2 + (tap * kC3 + c) * C4 + o), acc[o]);
      }
    T* dst = static_cast<T*>(p.out) + ((b * rows + gy) * cols + gx) * C4;
#pragma unroll
    for (int o = 0; o < C4; ++o) {
      const float v = acc[o] + p.b2[o];
      dst[o] = from_f32<T>(p.sigmoid ? 1.f / (1.f + expf(-v)) : fmaxf(v, 0.f));
    }
  }
}

template <typename T, int C4>
int launch(Args a, int64_t batch, int64_t in_h, int64_t in_w, cudaStream_t stream) {
  const int64_t tiles_y = (2 * in_h + kTile - 1) / kTile, tiles_x = (2 * in_w + kTile - 1) / kTile;
  const int64_t blocks = batch * tiles_y * tiles_x;
  if (blocks > 0x7fffffff || in_h > (1 << 28) || in_w > (1 << 28)) return cudaErrorInvalidValue;
  a.in_h = (int)in_h;
  a.in_w = (int)in_w;
  a.tiles_y = (int)tiles_y;
  a.tiles_x = (int)tiles_x;
  // x's staging: 16-byte pieces of channels, pairs of pixels (bf16, an even
  // width), or elements.
  constexpr int64_t kVec = 16 / sizeof(T);
  if (a.sc == 1 && aligned16(a.x) && a.sw % kVec == 0 && a.sh % kVec == 0 && a.sb % kVec == 0)
    a.xmode = 1;
  else if (sizeof(T) == 2 && a.sw == 1 && in_w % 2 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 3) == 0 &&
           a.sh % 2 == 0 && a.sc % 2 == 0 && a.sb % 2 == 0)
    a.xmode = 2;
  else
    a.xmode = 0;
  auto kernel = fused_tail_kernel<T, C4>;
  const cudaError_t err = allow_smem(kernel, Cfg<T>::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, Cfg<T>::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tail
}  // namespace tchvp

extern "C" {

// x: (batch, in_h, in_w, 384) fp32 (is_bf16 0) or bf16 (is_bf16 1) with
// element strides sb, sh, sw, sc; out: (batch, 2 in_h, 2 in_w, c4)
// contiguous, x's dtype. The weights are contiguous and 16-byte aligned, in
// the layouts of fused_tail.py's pack_tail_weights, every value rounded to
// x's dtype: w_up (768, 384) (the folded w_up transposed, rows (di, dj, c)),
// w0 (9, 64, 192) and w1 (8, 9 * 64) (per tap, output channel by input
// channel) in x's dtype; b_up (192), b0 (64), b1 (8), w2 (3, 3, 8, c4) and
// b2 (c4) in fp32. c4 is 3 or 1, sigmoid 1 for the mask head. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
int tchvp_fused_tail(const void* x, void* out, const void* w_up, const void* b_up,
                     const void* w0, const void* b0, const void* w1, const void* b1,
                     const void* w2, const void* b2, int64_t batch, int64_t in_h, int64_t in_w,
                     int64_t sb, int64_t sh, int64_t sw, int64_t sc, int c4, int sigmoid,
                     int is_bf16, void* stream) {
  using tchvp::tail::launch;
  tchvp::tail::Args a{x, out, w_up, static_cast<const float*>(b_up), w0, static_cast<const float*>(b0),
                      w1, static_cast<const float*>(b1), static_cast<const float*>(w2),
                      static_cast<const float*>(b2), 0, 0, sb, sh, sw, sc, 0, 0, sigmoid, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c4 == 3)
    return is_bf16 ? launch<__nv_bfloat16, 3>(a, batch, in_h, in_w, s) : launch<float, 3>(a, batch, in_h, in_w, s);
  if (c4 == 1)
    return is_bf16 ? launch<__nv_bfloat16, 1>(a, batch, in_h, in_w, s) : launch<float, 1>(a, batch, in_h, in_w, s);
  return cudaErrorInvalidValue;
}

const char* tchvp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
