// K2: one fused DownConv stage of the encoder stem:
//   conv3x3/s2 SAME + bias + Mish -> conv3x3 + bias + Mish
//   -> conv3x3 + bias + Mish,
// NHWC in (B, H, W, Cin) and out (B, H/2, W/2, CO).
// Replaces qpwcnet_tpu/ops/pallas/stem_kernel.py:_stem_kernel.
//
// SAME for the stride-2 conv on an even input pads (0, 1): output (i, j)
// reads x[2i+dy, 2j+dx], dy, dx in 0..2, zero at row H / column W. The
// weights are the stored float32 OIHW (CO, Ci, 3, 3) tensors and the
// biases the float32 (CO,), read as stored. Each conv's weights and bias
// are rounded to the compute dtype T, the sum is taken in float, rounded
// to T, the bias added in T and Mish applied in T: the rounding points of
// the unfused composition (ops/cuda/stem_kernel.py:downconv_stage_plain).
//
// Both bodies keep the two intermediates in shared memory: conv_a's
// output over the output tile plus a 2-pixel halo (A) and conv_aa's over
// a 1-pixel halo (B). Halo positions outside the image are stored as
// zero: that is the next conv's SAME padding. So a stage reads its input
// and writes its output once. The TPU kernel's space-to-depth phase
// input, lane-padded flat layout and 0/1 mask planes are not needed.
//
// What bounds it on the H100: 9 * CO * (Ci + 2 CO) multiply-adds an output
// pixel against 2 Ci bytes of each of its four input pixels in and 2 CO
// out: ~180 operations a byte at (448x1024, 3) -> 16 and ~240 at 16 -> 32,
// under the bf16 tensor cores' ridge point (~295), so the bytes bound it;
// on the CUDA cores (67 TFLOP/s) the multiply-adds would, about ten times
// higher. As built (PERF.md), the three convs' Mish epilogues
// (halos included), the products with their ldmatrix loads, and the
// staging, stores and barriers each take a quarter to a half of its
// time, and they add up: they barely overlap.
//
// bfloat16 body (stem_mma_kernel): an implicit GEMM per conv on the
// tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums, operands
// by ldmatrix): M = 16 positions of a region (row-major, so an m16 tile
// may wrap a row: ldmatrix takes each row's address per lane), N = CO,
// K = taps x input channels.
//  - The input tile, all the rows and columns conv_a reads for A, is
//    staged in shared memory, zero outside the image. For Ci > 4 the
//    pixels are [y][x parity][x / 2][ci] with a pixel stride Ci + 8 (Ci
//    padded to 16) bf16, an odd number of 16-byte units: conv_a's A rows
//    are the stride-2 pixels 2x + dx, consecutive in one parity plane, so
//    ldmatrix's eight row reads fall in distinct banks; copied with
//    cp.async where Ci is a multiple of 8. For Ci <= 4 (the stem's RGB
//    input) the pixels are [y][x][4]: the 16 bf16 from pixel 2x on are
//    the taps dx = 0..2 (and one zero-weighted pixel) of all channels, so
//    conv_a takes K = 3 x 16 (one k16 step a kernel row) instead of 9 x 16.
//  - A and B are [y][x][c] with a pixel stride CO + 8; each 3x3 tap is a
//    shifted row read of the same region (no im2col). The epilogue writes
//    each conv's result from the accumulators into the next region; the
//    last conv stores straight to the output. It works on channel pairs:
//    the sums' rounding, the bias add and Mish's last product are bf16x2
//    instructions (common.cuh:mish2), which round as the float path does.
//  - The weights are rounded to bf16 into shared memory as [tap][co][ci]
//    (ci contiguous: B's column-major fragment). The grid is persistent:
//    each block stages all three convs' weights once and keeps them. A
//    block copies its next tile's input while it computes conv_aa and
//    conv_b of the current one.
//  - Tiles: 16 x 32 outputs at CO 16 from RGB (2 blocks an SM), 16 x 16 at
//    CO 32 (one block an SM, 16 warps), as shared memory allows.
// float32 body (stem_kernel): CUDA-core FMAs, kept so that float32 stays
// equal to the plain version within 1e-5 (TF32 would not): a 16 x 16
// tile, one thread all CO sums of a position, the intermediates
// channel-major.
//
// Wide stages (CO 64, 128 and 256, encoder stages 2-4, both dtypes): one
// 256 -> 256 conv's bf16 weights are 1.2 MB, five times a block's shared
// memory, and the two intermediates and the stride-2 input of even a
// 4 x 4 output tile take 131 KB, so the fused tile would recompute conv_a
// on 4x and conv_aa on 2.25x the outputs; at CO 64 the fused tile had to
// restage each conv's 83 KB of weights for every 8 x 16 outputs, and
// took 2.4x the GEMM's chained time at the headline's stage 2
// (PERF.md). These stages run one implicit GEMM a conv
// instead (conv_gemm.cuh), the weights streamed through shared memory in
// channel slices of a tap:
// prep_w33 rounds the three convs' weights into the GEMM's layout, then
// conv_a writes its output into `out`, conv_aa reads it into the
// wrapper's scratch `tmp`, and conv_b reads that back into `out`. The
// intermediates are rounded where the unfused composition rounds them.
// Four device kernels, one wrapper launch, as the TPU's one pallas_call.
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "conv_gemm.cuh"
#include "mma.cuh"

namespace qpw {

// ---------------------------------------------------------------- float32

constexpr int ST_TS = 16;             // output tile
constexpr int ST_SA = ST_TS + 4;      // conv_a region: 2-pixel halo
constexpr int ST_SB = ST_TS + 2;      // conv_aa region: 1-pixel halo
constexpr int ST_THREADS = 256;

// The OIHW (CO, cin, 3, 3) weight into shared memory as [ci][ky][kx][co].
template <int CO>
__device__ __forceinline__ void load_weights(float* wsm, const float* w,
                                             int cin) {
  for (int i = threadIdx.x; i < 9 * cin * CO; i += ST_THREADS)
    wsm[(i % (9 * cin)) * CO + i / (9 * cin)] = w[i];
}

// bias + Mish of one position's CO sums.
template <int CO>
__device__ __forceinline__ void epilogue(float (&acc)[CO],
                                         const float* __restrict__ bias) {
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = mish<float>(acc[co] + bias[co]);
}

// 3x3 stride-1 conv of CO channels from a channel-major shared region of
// side `src_side` at offset (sy, sx) of the output position's window.
template <int CO>
__device__ __forceinline__ void conv33_smem(float (&acc)[CO], const float* src,
                                            int src_side, int sy, int sx,
                                            const float* wsm) {
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.0f;
  const int area = src_side * src_side;
  for (int ci = 0; ci < CO; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float v = src[ci * area + (sy + ky) * src_side + sx + kx];
        const float* wk = wsm + ((ci * 3 + ky) * 3 + kx) * CO;
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[co] = fmaf(v, wk[co], acc[co]);
      }
    }
  }
}

template <int CO>
__global__ void __launch_bounds__(ST_THREADS)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, const float* __restrict__ w3,
            const float* __restrict__ b3, float* __restrict__ out, int H,
            int W, int Cin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);  // [CO][SA*SA]
  float* sb = sa + CO * ST_SA * ST_SA;              // [CO][SB*SB]
  float* wsm = sb + CO * ST_SB * ST_SB;             // [ci][ky][kx][co]

  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * ST_TS, ox0 = blockIdx.x * ST_TS;
  const float* xb = x + (size_t)b * H * W * Cin;
  float acc[CO];

  // conv_a (stride 2) over the 2-pixel-haloed region, input from memory.
  load_weights<CO>(wsm, w1, Cin);
  __syncthreads();
  for (int p = threadIdx.x; p < ST_SA * ST_SA; p += ST_THREADS) {
    const int oy = oy0 - 2 + p / ST_SA, ox = ox0 - 2 + p % ST_SA;
    const bool inside = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
    if (inside) {
#pragma unroll
      for (int co = 0; co < CO; ++co) acc[co] = 0.0f;
      for (int ky = 0; ky < 3; ++ky) {
        const int iy = 2 * oy + ky;
        if (iy >= H) continue;
        for (int kx = 0; kx < 3; ++kx) {
          const int ix = 2 * ox + kx;
          if (ix >= W) continue;
          const float* xp = xb + ((size_t)iy * W + ix) * Cin;
          for (int ci = 0; ci < Cin; ++ci) {
            const float v = xp[ci];
            const float* wk = wsm + ((ci * 3 + ky) * 3 + kx) * CO;
#pragma unroll
            for (int co = 0; co < CO; ++co) acc[co] = fmaf(v, wk[co], acc[co]);
          }
        }
      }
      epilogue<CO>(acc, b1);
    }
#pragma unroll
    for (int co = 0; co < CO; ++co)
      sa[co * ST_SA * ST_SA + p] = inside ? acc[co] : 0.0f;
  }
  __syncthreads();

  // conv_aa over the 1-pixel-haloed region, from A.
  load_weights<CO>(wsm, w2, CO);
  __syncthreads();
  for (int p = threadIdx.x; p < ST_SB * ST_SB; p += ST_THREADS) {
    const int py = p / ST_SB, px = p % ST_SB;
    const int oy = oy0 - 1 + py, ox = ox0 - 1 + px;
    const bool inside = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
    if (inside) {
      conv33_smem<CO>(acc, sa, ST_SA, py, px, wsm);
      epilogue<CO>(acc, b2);
    }
#pragma unroll
    for (int co = 0; co < CO; ++co)
      sb[co * ST_SB * ST_SB + p] = inside ? acc[co] : 0.0f;
  }
  __syncthreads();

  // conv_b over the tile, from B, straight to memory.
  load_weights<CO>(wsm, w3, CO);
  __syncthreads();
  for (int p = threadIdx.x; p < ST_TS * ST_TS; p += ST_THREADS) {
    const int py = p / ST_TS, px = p % ST_TS;
    const int oy = oy0 + py, ox = ox0 + px;
    if (oy >= Ho || ox >= Wo) continue;
    conv33_smem<CO>(acc, sb, ST_SB, py, px, wsm);
    epilogue<CO>(acc, b3);
    float* o = out + (((size_t)b * Ho + oy) * Wo + ox) * CO;
#pragma unroll
    for (int co = 0; co < CO; ++co) o[co] = acc[co];
  }
}

template <int CO>
cudaError_t launch_stem_f32(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, void* out, int B, int H, int W,
                            int Cin, cudaStream_t stream) {
  const int wmax = 9 * (Cin > CO ? Cin : CO) * CO;
  const size_t smem =
      sizeof(float) * ((size_t)CO * (ST_SA * ST_SA + ST_SB * ST_SB) + wmax);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int Ho = H / 2, Wo = W / 2;
  const dim3 grid((Wo + ST_TS - 1) / ST_TS, (Ho + ST_TS - 1) / ST_TS, B);
  using P = const float*;
  stem_kernel<CO><<<grid, ST_THREADS, smem, stream>>>(
      static_cast<P>(x), static_cast<P>(w1), static_cast<P>(b1),
      static_cast<P>(w2), static_cast<P>(b2), static_cast<P>(w3),
      static_cast<P>(b3), static_cast<float*>(out), H, W, Cin);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16

constexpr int SM_SMEM_MAX = 232448;  // 227 KB a block (sm_90)

// Geometry of one instantiation. PACKED: Ci <= 4, input pixels of 4
// channels, conv_a K = 3 x 16; else Ci padded to cip (a multiple of 16).
template <int CO, bool PACKED>
struct StemCfg {
  static constexpr bool RGB16 = CO == 16 && PACKED;
  static constexpr int TH = 16;                     // output rows of a tile
  static constexpr int TW = RGB16 ? 32 : 16;        // output columns
  static constexpr int NW = RGB16 ? 8 : 16;         // warps
  static constexpr int MINB = RGB16 ? 2 : 1;        // blocks an SM
  static constexpr int PS = CO + 8;                 // A, B pixel stride
  static constexpr int AW = TW + 4, NA = (TH + 4) * AW;
  static constexpr int BW = TW + 2, NB = (TH + 2) * BW;
  static constexpr int IH = 2 * TH + 9;             // staged input rows
  static constexpr int PWP = 2 * TW + 10;           // PACKED: columns
  static constexpr int PW = TW + 5;                 // else: a parity plane
  static constexpr int WS = 9 * CO * PS;            // a CO -> CO conv
  __host__ __device__ static constexpr int in_el(int cip) {
    return PACKED ? IH * PWP * 4 : IH * 2 * PW * (cip + 8);
  }
  __host__ __device__ static constexpr int wa_el(int cip) {
    return PACKED ? 3 * CO * 24 : 9 * CO * (cip + 8);
  }
  __host__ __device__ static constexpr int w_el(int cip) {
    return wa_el(cip) + 2 * WS;
  }
  static size_t smem(int cip) {
    return 2 * ((size_t)(NA + NB) * PS + in_el(cip) + w_el(cip));
  }
};

// A CO -> ... 3x3 conv's OIHW float32 weight (CO, cin, 3, 3) into dst as
// bf16 [tap][co][kp + 8], zero for cin <= ci < kp. A thread takes two
// channels of one co (9 taps each, contiguous), so a warp's shared stores
// of one tap are consecutive words.
template <int CO, int NT>
__device__ void stage_w33(bf16* dst, const float* __restrict__ w, int cin,
                          int kp) {
  const int ps = kp + 8, half = kp / 2;
  for (int e = threadIdx.x; e < CO * half; e += NT) {
    const int co = e / half, ci = 2 * (e % half);
    const float* w0 = w + ((size_t)co * cin + ci) * 9;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      __nv_bfloat162 v;
      v.x = __float2bfloat16_rn(ci < cin ? __ldg(w0 + tap) : 0.0f);
      v.y = __float2bfloat16_rn(ci + 1 < cin ? __ldg(w0 + 9 + tap) : 0.0f);
      *reinterpret_cast<__nv_bfloat162*>(dst + (tap * CO + co) * ps + ci) = v;
    }
  }
}

// PACKED conv_a weight: dst [dy][co][24], k = dx * 4 + c for k < 16:
// W[co, c, dy, dx], zero for dx = 3 or c >= cin.
template <int CO, int NT>
__device__ void stage_w_packed(bf16* dst, const float* __restrict__ w,
                               int cin) {
  for (int e = threadIdx.x; e < 3 * CO * 16; e += NT) {
    const int k = e % 16, co = (e / 16) % CO, dy = e / (16 * CO);
    const int dx = k / 4, c = k % 4;
    const float v =
        dx < 3 && c < cin ? __ldg(w + ((co * cin + c) * 3 + dy) * 3 + dx)
                          : 0.0f;
    dst[(dy * CO + co) * 24 + k] = __float2bfloat16_rn(v);
  }
}

// Stage the input that conv_a reads for the A region of the tile at
// output (oy0, ox0) of image b: rows 2 (oy0 - 2) + 0 .. IH - 1, columns
// 2 (ox0 - 2) + 0 .., zero outside the image and past Ci. vec: cp.async
// 16-byte copies (Ci a multiple of 8, x 16-byte aligned); else
// synchronous element loads.
template <int CO, bool PACKED, int NT>
__device__ __forceinline__ void stage_input(bf16* xs,
                                            const bf16* __restrict__ x,
                                            int b, int oy0, int ox0, int H,
                                            int W, int Ci, int cip,
                                            bool vec) {
  using C = StemCfg<CO, PACKED>;
  const int gy0 = 2 * (oy0 - 2), gx0 = 2 * (ox0 - 2);
  const bf16* xb = x + (size_t)b * H * W * Ci;
  if constexpr (PACKED) {
    // 3-channel pixels are not 16-byte units: element loads, U pixels a
    // thread issued before any is stored, so that they overlap.
    constexpr int U = 4;
    for (int e0 = threadIdx.x; e0 < C::IH * C::PWP; e0 += U * NT) {
      unsigned short v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT;
        const int gy = gy0 + e / C::PWP, gx = gx0 + e % C::PWP;
        const bool in = e < C::IH * C::PWP && gy >= 0 && gy < H && gx >= 0 &&
                        gx < W;
        const bf16* src = in ? xb + ((size_t)gy * W + gx) * Ci : x;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[u][c] = in && c < Ci ? __bfloat16_as_ushort(src[c]) : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT;
        if (e < C::IH * C::PWP)
          *reinterpret_cast<uint2*>(xs + e * 4) = make_uint2(
              v[u][0] | (unsigned)v[u][1] << 16,
              v[u][2] | (unsigned)v[u][3] << 16);
      }
    }
  } else {
    const int ps = cip + 8, nc = cip / 8;
    for (int e = threadIdx.x; e < C::IH * 2 * C::PW * nc; e += NT) {
      const int c = (e % nc) * 8, pix = e / nc;
      const int iy = pix / (2 * C::PW), ix = pix % (2 * C::PW);
      const int gy = gy0 + iy, gx = gx0 + ix;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      bf16* dst = xs + ((iy * 2 + (ix & 1)) * C::PW + (ix >> 1)) * ps + c;
      const bf16* src = in ? xb + ((size_t)gy * W + gx) * Ci + c : x;
      if (vec) {
        cp_async16(dst, src, in && c < Ci ? 16 : 0);
      } else {
        __align__(16) unsigned short v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = in && c + k < Ci ? __bfloat16_as_ushort(src[k]) : 0;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
  }
}

// One conv over the n positions of a region: each warp takes m16 tiles of
// positions in turn. a_row(q, tap): the element offset in src of position
// q's A row for the tap; ws [tap][co][kin + 8]; K = NTAPS x kin. The
// epilogue rounds the sums to bf16 pairs, adds the bias and applies Mish
// in bf16 (bf16x2 instructions: the sum of two bf16 values rounds to bf16
// as the float sum does) and hands put(q, n, v) channels n, n + 1 of
// position q.
template <int CO, int NTAPS, int NW, class ARow, class Put>
__device__ __forceinline__ void conv_mma(int n, int kin, const bf16* src,
                                         const bf16* ws,
                                         const float* __restrict__ bias,
                                         ARow a_row, Put put) {
  constexpr int N8 = CO / 8;  // n8 tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wps = kin + 8;
  __nv_bfloat162 bz[N8];
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) {
    const int c = nt * 8 + 2 * (lane & 3);
    bz[nt] = __floats2bfloat162_rn(__ldg(bias + c), __ldg(bias + c + 1));
  }

  for (int q0 = warp * 16; q0 < n; q0 += NW * 16) {
    // ldmatrix rows: A's lane l -> position q0 + l % 16 (the last one for
    // l past n), channels +8 for l >= 16; B's lane l -> co (l / 16) * 8 +
    // l % 8 of a 16-wide pair, channels +8 for odd l / 8.
    const int qa = min(q0 + (lane & 15), n - 1);
    float acc[N8][4];
#pragma unroll
    for (int nt = 0; nt < N8; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < NTAPS; ++tap) {
      const uint32_t aa = smem_addr(src + a_row(qa, tap) + (lane >> 4) * 8);
      uint32_t ba[N8 / 2];
#pragma unroll
      for (int np = 0; np < N8 / 2; ++np)
        ba[np] = smem_addr(ws + (tap * CO + np * 16 + (lane >> 4) * 8 +
                                 (lane & 7)) * wps +
                           ((lane >> 3) & 1) * 8);
      for (int kk = 0; kk < kin; kk += 16) {
        uint32_t af[4], bf[N8 / 2][4];
        ldmatrix_x4(af, aa + 2 * kk);
#pragma unroll
        for (int np = 0; np < N8 / 2; ++np) ldmatrix_x4(bf[np], ba[np] + 2 * kk);
#pragma unroll
        for (int nt = 0; nt < N8; ++nt)
          mma_bf16(acc[nt], af, bf[nt / 2][2 * (nt & 1)],
                   bf[nt / 2][2 * (nt & 1) + 1]);
      }
    }
    // acc[nt][k]: position q0 + lane / 4 + 8 (k / 2), channel nt * 8 +
    // 2 (lane % 4) + k % 2.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + (lane >> 2) + 8 * h;
      if (q >= n) continue;
#pragma unroll
      for (int nt = 0; nt < N8; ++nt) {
        const __nv_bfloat162 y = __hadd2(
            __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]), bz[nt]);
        put(q, nt * 8 + 2 * (lane & 3), mish2(y));
      }
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, __nv_bfloat162 v, bool in) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      in ? v : __floats2bfloat162_rn(0.0f, 0.0f);
}

template <int CO, bool PACKED>
__global__ void __launch_bounds__(StemCfg<CO, PACKED>::NW * 32,
                                  StemCfg<CO, PACKED>::MINB)
stem_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, bf16* __restrict__ out, int H,
                int W, int Ci, int cip, int tiles_w, int tiles_h,
                int n_tiles, int vec) {
  using C = StemCfg<CO, PACKED>;
  constexpr int NT = C::NW * 32, PS = C::PS;
  extern __shared__ __align__(16) unsigned char st_smem[];
  bf16* sa = reinterpret_cast<bf16*>(st_smem);  // A [NA][PS]
  bf16* sb = sa + C::NA * PS;                    // B [NB][PS]
  bf16* xs = sb + C::NB * PS;                    // the staged input
  bf16* wa = xs + C::in_el(cip);                 // conv_a's weights
  bf16* waa = wa + C::wa_el(cip);
  bf16* wb = waa + C::WS;
  const int Ho = H / 2, Wo = W / 2;

  auto tile = [&](int t, int& b, int& oy0, int& ox0) {
    ox0 = (t % tiles_w) * C::TW;
    oy0 = (t / tiles_w % tiles_h) * C::TH;
    b = t / (tiles_w * tiles_h);
  };

  int t = blockIdx.x, b = 0, oy0 = 0, ox0 = 0;
  tile(t, b, oy0, ox0);
  stage_input<CO, PACKED, NT>(xs, x, b, oy0, ox0, H, W, Ci, cip, vec);
  cp_async_commit();
  if constexpr (PACKED)
    stage_w_packed<CO, NT>(wa, w1, Ci);
  else
    stage_w33<CO, NT>(wa, w1, Ci, cip);
  stage_w33<CO, NT>(waa, w2, CO, CO);
  stage_w33<CO, NT>(wb, w3, CO, CO);

  for (; t < n_tiles; t += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // the input and the weights are in place

    // conv_a (stride 2): the staged input -> A, over the tile + 2 halo.
    const int cb = b, cy0 = oy0, cx0 = ox0;
    auto put_a = [&](int q, int n, __nv_bfloat162 v) {
      const int oy = cy0 - 2 + q / C::AW, ox = cx0 - 2 + q % C::AW;
      const bool in = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
      store2(sa + q * PS + n, v, in);
    };
    if constexpr (PACKED) {
      conv_mma<CO, 3, C::NW>(
          C::NA, 16, xs, wa, b1,
          [](int q, int dy) {
            return ((2 * (q / C::AW) + dy) * C::PWP + 2 * (q % C::AW)) * 4;
          },
          put_a);
    } else {
      const int ips = cip + 8;
      conv_mma<CO, 9, C::NW>(
          C::NA, cip, xs, wa, b1,
          [ips](int q, int tap) {
            const int dy = tap / 3, dx = tap % 3;
            return (((2 * (q / C::AW) + dy) * 2 + (dx & 1)) * C::PW +
                    q % C::AW + (dx >> 1)) * ips;
          },
          put_a);
    }
    __syncthreads();  // A is complete; the staged input is read

    // The next tile's input, under conv_aa and conv_b.
    if (t + (int)gridDim.x < n_tiles) {
      tile(t + gridDim.x, b, oy0, ox0);
      stage_input<CO, PACKED, NT>(xs, x, b, oy0, ox0, H, W, Ci, cip, vec);
    }
    cp_async_commit();

    // conv_aa: A -> B, over the tile + 1 halo.
    conv_mma<CO, 9, C::NW>(
        C::NB, CO, sa, waa, b2,
        [](int q, int tap) {
          return ((q / C::BW + tap / 3) * C::AW + q % C::BW + tap % 3) * PS;
        },
        [&](int q, int n, __nv_bfloat162 v) {
          const int oy = cy0 - 1 + q / C::BW, ox = cx0 - 1 + q % C::BW;
          const bool in = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
          store2(sb + q * PS + n, v, in);
        });
    __syncthreads();  // B is complete

    // conv_b: B -> the output tile.
    conv_mma<CO, 9, C::NW>(
        C::TH * C::TW, CO, sb, wb, b3,
        [](int q, int tap) {
          return ((q / C::TW + tap / 3) * C::BW + q % C::TW + tap % 3) * PS;
        },
        [&](int q, int n, __nv_bfloat162 v) {
          const int oy = cy0 + q / C::TW, ox = cx0 + q % C::TW;
          if (oy < Ho && ox < Wo)
            *reinterpret_cast<__nv_bfloat162*>(
                out + (((size_t)cb * Ho + oy) * Wo + ox) * CO + n) = v;
        });
  }
}

// Resident blocks of each instantiation, by device and cip / 16 (0 for
// PACKED): found once (the shared-memory opt-in and the occupancy query
// cost microseconds of host time a call) and kept, as blocks + 1 (0: not
// known yet).
namespace {
constexpr int SM_MAX_DEV = 16, SM_MAX_K = 3;
std::atomic<int> sm_known[2][2][SM_MAX_DEV][SM_MAX_K];
}  // namespace

template <int CO, bool PACKED>
cudaError_t launch_stem_mma(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, void* out, int B, int H, int W,
                            int Ci, cudaStream_t stream) {
  using C = StemCfg<CO, PACKED>;
  const int cip = PACKED ? 0 : (Ci + 15) / 16 * 16;
  const size_t smem = C::smem(cip);
  if (smem > (size_t)SM_SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = stem_mma_kernel<CO, PACKED>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int k = cip / 16;
  std::atomic<int>* known =
      dev < SM_MAX_DEV && k < SM_MAX_K
          ? &sm_known[CO == 16 ? 0 : 1][PACKED][dev][k]
          : nullptr;
  int resident = known ? known->load(std::memory_order_relaxed) - 1 : -1;
  if (resident < 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, C::NW * 32, smem);
    if (err != cudaSuccess) return err;
    resident = per_sm * n_sm;
    if (known) known->store(resident + 1, std::memory_order_relaxed);
  }
  if (resident < 1) return cudaErrorInvalidConfiguration;

  const int Ho = H / 2, Wo = W / 2;
  const int tiles_w = (Wo + C::TW - 1) / C::TW;
  const int tiles_h = (Ho + C::TH - 1) / C::TH;
  const long long n_tiles = (long long)B * tiles_h * tiles_w;
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < resident ? n_tiles : resident);
  const bool vec = !PACKED && Ci % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  using P = const float*;
  kern<<<grid, C::NW * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<P>(w1), static_cast<P>(b1),
      static_cast<P>(w2), static_cast<P>(b2), static_cast<P>(w3),
      static_cast<P>(b3), static_cast<bf16*>(out), H, W, Ci, cip, tiles_w,
      tiles_h, (int)n_tiles, vec ? 1 : 0);
  return cudaGetLastError();
}

template <int CO>
cudaError_t launch_stem_bf16(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* w3,
                             const void* b3, void* out, int B, int H, int W,
                             int Ci, cudaStream_t s) {
  if (Ci <= 4)
    return launch_stem_mma<CO, true>(x, w1, b1, w2, b2, w3, b3, out, B, H, W,
                                     Ci, s);
  return launch_stem_mma<CO, false>(x, w1, b1, w2, b2, w3, b3, out, B, H, W,
                                    Ci, s);
}

// ------------------------------------------------------ wide: conv_gemm.cuh

// The three convs' OIHW float32 weights (CO, cin, 3, 3), cin = Cin for
// conv_a and CO for the others, into conv_gemm.cuh's layout rounded to T
// (blockIdx.y = conv): bf16 [tap][co][kp], float32 [tap][kp][co], kp =
// cin rounded up to GEMM_K, zero past cin. A thread takes two channels of
// one co, whose 9 taps are contiguous in the source.
template <typename T>
__global__ void prep_w33(const float* __restrict__ w1,
                         const float* __restrict__ w2,
                         const float* __restrict__ w3, T* __restrict__ dst,
                         int Cin, int cip, int CO) {
  const int k = blockIdx.y;
  const float* w = k == 0 ? w1 : k == 1 ? w2 : w3;
  const int cin = k == 0 ? Cin : CO, kp = k == 0 ? cip : CO;
  T* d = dst + (k == 0 ? 0 : 9 * CO * (cip + (k - 1) * CO));
  const int half = kp / 2;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < CO * half;
       e += gridDim.x * blockDim.x) {
    const int co = e / half, ci = 2 * (e % half);
    const float* w0 = w + ((size_t)co * cin + ci) * 9;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float v0 = ci < cin ? __ldg(w0 + tap) : 0.0f;
      const float v1 = ci + 1 < cin ? __ldg(w0 + 9 + tap) : 0.0f;
      if constexpr (std::is_same<T, float>::value) {
        d[((size_t)tap * kp + ci) * CO + co] = v0;
        d[((size_t)tap * kp + ci + 1) * CO + co] = v1;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(d + ((size_t)tap * CO + co) * kp +
                                           ci) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// A wide stage: wbuf holds 9 CO (cip + 2 CO) elements of T (cip = Cin
// rounded up to GEMM_K), tmp one (B, H/2, W/2, CO) map. bf16 GEMM tiles
// are 128 channels wide at CO 128 and 256, 64 at CO 64.
template <typename T>
cudaError_t launch_stem_gemm(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* w3,
                             const void* b3, void* out, void* wbuf, void* tmp,
                             int B, int H, int W, int Ci, int CO,
                             cudaStream_t stream) {
  if (!tmp) return cudaErrorInvalidValue;
  const int cip = (Ci + GEMM_K - 1) / GEMM_K * GEMM_K;
  const int Ho = H / 2, Wo = W / 2;
  const long long M = (long long)B * Ho * Wo;
  if (M > 0x7fffffff) return cudaErrorInvalidValue;
  T* wp = static_cast<T*>(wbuf);
  prep_w33<T><<<dim3((CO * (cip > CO ? cip : CO) / 2 + 255) / 256, 3), 256,
                 0, stream>>>(static_cast<const float*>(w1),
                              static_cast<const float*>(w2),
                              static_cast<const float*>(w3), wp, Ci, cip, CO);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using F = const float*;
  const ConvArgs a = {x, wp, static_cast<F>(b1), out, H, W, Ci, cip, CO,
                      Ho, Wo, (int)M};
  const ConvArgs aa = {out, wp + 9 * CO * cip, static_cast<F>(b2), tmp,
                       Ho, Wo, CO, CO, CO, Ho, Wo, (int)M};
  const ConvArgs ab = {tmp, wp + 9 * CO * (cip + CO), static_cast<F>(b3),
                       out, Ho, Wo, CO, CO, CO, Ho, Wo, (int)M};
  if (CO % 128) {
    err = launch_conv_gemm<CONV_S2, T, 64>(a, stream);
    if (err == cudaSuccess) err = launch_conv_gemm<CONV_S1, T, 64>(aa, stream);
    if (err == cudaSuccess) err = launch_conv_gemm<CONV_S1, T, 64>(ab, stream);
    return err;
  }
  err = launch_conv_gemm<CONV_S2, T, 128>(a, stream);
  if (err == cudaSuccess) err = launch_conv_gemm<CONV_S1, T, 128>(aa, stream);
  if (err == cudaSuccess) err = launch_conv_gemm<CONV_S1, T, 128>(ab, stream);
  return err;
}

}  // namespace qpw

extern "C" int qpw_downconv_stage(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* w3,
                                  const void* b3, void* out, void* wbuf,
                                  void* tmp, int B, int H, int W, int Cin,
                                  int Cout, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 2 || W < 2 || Cin < 1) return cudaErrorInvalidValue;
  // The wrapper passes the GEMM's scratch at the wide widths
  // (ops/cuda/stem_kernel.py:STEM_GEMM_CHANNELS) and null otherwise.
  if (wbuf && dtype == 0)
    return qpw::launch_stem_gemm<float>(x, w1, b1, w2, b2, w3, b3, out, wbuf,
                                        tmp, B, H, W, Cin, Cout, s);
  if (wbuf && dtype == 1)
    return qpw::launch_stem_gemm<qpw::bf16>(x, w1, b1, w2, b2, w3, b3, out,
                                            wbuf, tmp, B, H, W, Cin, Cout, s);
  if (dtype == 0 && Cout == 16)
    return qpw::launch_stem_f32<16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W,
                                    Cin, s);
  if (dtype == 0 && Cout == 32)
    return qpw::launch_stem_f32<32>(x, w1, b1, w2, b2, w3, b3, out, B, H, W,
                                    Cin, s);
  if (dtype == 1 && Cout == 16)
    return qpw::launch_stem_bf16<16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W,
                                     Cin, s);
  if (dtype == 1 && Cout == 32)
    return qpw::launch_stem_bf16<32>(x, w1, b1, w2, b2, w3, b3, out, B, H, W,
                                     Cin, s);
  return cudaErrorInvalidValue;
}
