// One convolution layer + bias + Mish as an implicit GEMM, one launch a
// layer: the bodies of K2 (stem.cu) at encoder stages 2-4 and of K5
// (upconv.cu) at decoder stages 0-1, in bf16 on the tensor cores, and of
// the float32 stages from Co 64 on, on the CUDA cores.
//
//   out[m][n] = Mish(bias[n] + sum_{tap, ci} x[pixel(m, tap)][ci] * W[tap][n][ci])
//
// M = positions, N = Co, K = taps x Cin. Three modes:
//  - CONV_S2: a 3x3 stride-2 SAME conv on an even input: position (y, x)
//    of the (H/2, W/2) output reads x[2y + dy, 2x + dx], dy, dx in 0..2,
//    zero at row H / column W (SAME pads (0, 1));
//  - CONV_S1: a 3x3 stride-1 SAME conv: x[y + dy - 1, x + dx - 1];
//  - CONV_UP: one output phase (r, s) of the 4x4 stride-2 transpose conv:
//    position (i, j) of the input reads its 4 taps
//    x[i + a - 1 + r, j + b - 1 + s], a, b in 0..1, and writes output
//    pixel (2i + r, 2j + s).
// Pixels outside the image read zero.
//
// The weights come prepared by the caller's source (stem.cu:prep_w33,
// upconv.cu:prep_wt) from the stored float32 layout, rounded to the
// compute dtype, in a scratch buffer the wrapper allocates:
// [phase x tap][Co][cip] bf16 (ci contiguous: wgmma's K-major B) and
// [phase x tap][cip][Co] float32, cip = Cin rounded up to GEMM_K (zeros
// past Cin).
//
// Rounding points: the sum is taken in float32; bf16 rounds it, adds the
// bias rounded to bf16 and applies Mish in bf16 (common.cuh:mish2), as
// the unfused composition does; float32 adds the bias and applies Mish in
// float32.
//
// What bounds it on the H100: at these stages a layer does 2 x 9 (or 4)
// x Cin multiply-adds per output value against ~2 bytes of input and
// output each: 300-2300 operations a byte, above the bf16 tensor cores'
// ridge (~295), so the operations bound it, and only wgmma reaches the
// tensor cores' full rate.
//
// bfloat16 body (conv_gemm_wgmma_kernel<MODE, BM, BN>): a tile is BM
// positions (a box of BM / 16 rows x 16 columns of one image) x BN
// channels. One producer thread keeps TMA loads of the (tap, channel
// slice) K steps in flight into a ring of shared-memory stages (full and
// empty mbarriers a stage); two consumer warpgroups run wgmma on the
// stages that have arrived, with both operands in shared memory in the
// 128-byte (64-byte) swizzle that TMA writes. No im2col, no masks: each
// step's A is one TMA box of the NHWC input at the tile's origin shifted
// by the tap (the stride-2 conv reads a 5D view of the same memory), and
// out-of-bounds boxes read zero. The grid is persistent (one block an
// SM), so a tile's epilogue (bias + Mish from the accumulators, stored
// from registers) runs while the producer loads the next tile. BM is 128,
// or 64 where 128-row tiles would leave half the SMs idle (stage 4 of the
// train step, K5's stage 0 of the pretraining step); BN is 128 (Co 128,
// 256) or 64 (Co 64). The two intermediates of a K2
// stage go through device memory (a stage-4 intermediate at batch 16 is
// 3.7 MB: it stays in the 50 MB L2).
// float32 body (conv_gemm_f32_kernel<MODE>): CUDA-core FMAs (TF32 would
// break the 1e-5 equality with the plain version), 64 x 64 a block of
// 256 threads, each 4 positions x 4 channels, K in 16-channel steps
// through shared memory, the next step's loads in registers meanwhile.
#pragma once

#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace qpw {

enum { CONV_S2 = 0, CONV_S1 = 1, CONV_UP = 2 };

constexpr int GEMM_K = 32;  // cip's multiple, and bf16's Cin's
constexpr int GEMM_THREADS = 256;

// The arguments of one layer. H, W: the input's; Hp, Wp: the position
// grid (the output for CONV_S2 / CONV_S1, the input for CONV_UP).
struct ConvArgs {
  const void* x;
  const void* w;  // the prepared weights
  const float* bias;
  void* out;
  int H, W, Cin, cip, Co, Hp, Wp, M;
};

template <int MODE>
__host__ __device__ constexpr int conv_taps() {
  return MODE == CONV_UP ? 4 : 9;
}

// The input pixel of position (y, x) for tap t of phase (r, s); false
// outside the image.
template <int MODE>
__device__ __forceinline__ bool tap_pixel(const ConvArgs& a, int y, int x,
                                          int t, int r, int s, int& iy,
                                          int& ix) {
  if constexpr (MODE == CONV_S2) {
    iy = 2 * y + t / 3, ix = 2 * x + t % 3;
  } else if constexpr (MODE == CONV_S1) {
    iy = y + t / 3 - 1, ix = x + t % 3 - 1;
  } else {
    iy = y + (t >> 1) - 1 + r, ix = x + (t & 1) - 1 + s;
  }
  return iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
}

// The element offset of position m's output pixel (channel 0).
template <int MODE>
__device__ __forceinline__ size_t out_offset(const ConvArgs& a, int m,
                                             int r, int s) {
  if constexpr (MODE == CONV_UP) {
    const int j = m % a.Wp, i = m / a.Wp % a.Hp, b = m / (a.Wp * a.Hp);
    return (((size_t)b * 2 * a.Hp + 2 * i + r) * 2 * a.Wp + 2 * j + s) *
           a.Co;
  } else {
    return (size_t)m * a.Co;
  }
}

// ---------------------------------------------------------------- bfloat16

constexpr int GW_THREADS = 384;      // a producer and two consumer warpgroups
constexpr int GW_RING_BYTES = 196608;  // the ring's shared memory

// Channels a K step (the swizzle's row: 64 bf16 = 128 bytes, or 32 = 64
// bytes where Cin is an odd multiple of 32). Cin must be a multiple of
// GEMM_K (32).
__host__ __device__ constexpr int gemm_kb(int cin) {
  return cin % 64 ? 32 : 64;
}

// A ring stage holds one K step of a BM x BN tile at 64 channels: (BM +
// BN) rows of 128 bytes (a 32-channel step fills half of it: sizing the
// stages to the step, twice as many, measured slower).
template <int BM, int BN>
__host__ __device__ constexpr int gemm_stages() {
  return GW_RING_BYTES / ((BM + BN) * 128);
}
// The ring, 1 KB to align it to the 128-byte swizzle's period, and a
// full and an empty barrier a stage.
template <int BM, int BN>
__host__ __device__ constexpr size_t gemm_smem() {
  return (size_t)GW_RING_BYTES + 1024 + 16 * gemm_stages<BM, BN>();
}

// One K step's products, kb / 16 wgmma in one straight run (a run split
// by a branch gets fences between its parts), committed as a group.
template <int WN>
__device__ __forceinline__ void mma_step(float (&acc)[WN / 2], uint64_t da,
                                         uint64_t db, int kb, bool first) {
  if (kb == 64) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<WN>::mma(acc, da + 2 * kk, db + 2 * kk, !first || kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      Wgmma<WN>::mma(acc, da + 2 * kk, db + 2 * kk, !first || kk > 0);
  }
  wgmma_commit();
}

// The position tiles of a layer: boxes of 16 columns x BM / 16 rows of
// one image (and one phase of CONV_UP), times Co / BN column blocks;
// tile t's block is t % n_blk, so neighbouring blocks share A in L2.
struct GemmTile {
  int nb, x0, y0, img, ph;
};

template <int BM, int BN>
__device__ __forceinline__ GemmTile gemm_tile(const ConvArgs& a, int t) {
  const int n_blk = a.Co / BN, tiles_x = (a.Wp + 15) / 16;
  const int tiles_y = (a.Hp + BM / 16 - 1) / (BM / 16);
  const int n_img = a.M / (a.Hp * a.Wp);
  GemmTile g;
  g.nb = t % n_blk;
  t /= n_blk;
  g.x0 = t % tiles_x * 16;
  t /= tiles_x;
  g.y0 = t % tiles_y * (BM / 16);
  t /= tiles_y;
  g.img = t % n_img;
  g.ph = t / n_img;
  return g;
}

template <int MODE, int BM, int BN>
__host__ __device__ inline int gemm_tiles(const ConvArgs& a) {
  const int nph = MODE == CONV_UP ? 4 : 1;
  return (a.Co / BN) * ((a.Wp + 15) / 16) *
         ((a.Hp + BM / 16 - 1) / (BM / 16)) * (a.M / (a.Hp * a.Wp)) * nph;
}

// Warp-specialised and persistent. Warpgroup 0's first thread is the
// producer: it walks the block's tiles (t = blockIdx.x + i gridDim.x)
// and their K steps ((tap, channel slice), tap-major) and keeps TMA loads
// in flight into a ring of stages, each with a full barrier (the
// producer's arrival and the step's bytes) and an empty one (one arrival
// from each consumer warp). Warpgroups 1 and 2 consume every step
// together: BM = 128 gives each a 64-row half of the tile on all BN
// columns, BM = 64 each BN / 2 columns of all 64 rows. A K step is kb / 16
// wgmma m64nWNk16 with both operands in shared memory; the stage of step
// k - 1 is released once step k's products are issued and step k - 1's
// have completed (wgmma.wait_group 1). After a tile's last step the
// consumers run the epilogue from the accumulators (bias + Mish, stored
// from registers) while the producer already loads the next tile. (The
// consumers taking turns on whole tiles of their own instead, so that one
// consumer's epilogue runs under the other's products, measured slower
// at every width but Co 64: PERF.md.)
//   A (the input, xmap): 4D (C, W, H, B) for CONV_S1 and CONV_UP; the same
//   memory as 5D (2C, W/2, 2, H/2, B) for CONV_S2, element
//   [b, yy, py, xx, px C + c] being pixel (2yy + py, 2xx + px). One box is
//   kb channels x 16 columns x BM / 16 rows, at the tile's origin shifted
//   by the tap: out-of-bounds boxes read zero, which is SAME's padding,
//   the image's edges and CONV_S2's zero row H and column W.
//   B (the prepared weights, wmap): 2D (cip, slots x Co), one box kb x BN
//   at (c0, (phase x taps + tap) x Co + n0).
template <int MODE, int BM, int BN>
__global__ void __launch_bounds__(GW_THREADS, 1)
conv_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const ConvArgs a) {
  constexpr int NTAP = conv_taps<MODE>();
  constexpr int WN = BM == 128 ? BN : BN / 2;  // a consumer's columns
  constexpr int STAGES = gemm_stages<BM, BN>();
  constexpr int A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  static_assert(STAGES >= 4, "the ring holds at least four stages");
  extern __shared__ unsigned char gw_smem[];
  unsigned char* ring =
      gw_smem + ((1024 - (smem_addr(gw_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + GW_RING_BYTES);
  uint64_t* empty = full + STAGES;

  const int kb = gemm_kb(a.Cin), kc = a.Cin / kb, KT = NTAP * kc;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_tiles = gemm_tiles<MODE, BM, BN>(a);

  if (tid < 128) {
    setmaxnreg_dec<40>();
    if (tid == 0) {
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
      int st = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const GemmTile g = gemm_tile<BM, BN>(a, t);
        const int r = g.ph >> 1, s = g.ph & 1;
        for (int k = 0; k < KT; ++k) {
          const int tap = k / kc, c0 = (k % kc) * kb;
          mbar_wait(&empty[st], phase ^ 1);
          mbar_expect_tx(&full[st], (BM + BN) * kb * 2);
          unsigned char* at = ring + st * STAGE_BYTES;
          if constexpr (MODE == CONV_S2) {
            const int dy = tap / 3, dx = tap % 3;
            tma_load_5d(at, &xmap, &full[st], (dx & 1) * a.Cin + c0,
                        g.x0 + (dx >> 1), dy & 1, g.y0 + (dy >> 1), g.img);
          } else if constexpr (MODE == CONV_S1) {
            tma_load_4d(at, &xmap, &full[st], c0, g.x0 + tap % 3 - 1,
                        g.y0 + tap / 3 - 1, g.img);
          } else {
            tma_load_4d(at, &xmap, &full[st], c0, g.x0 + (tap & 1) - 1 + s,
                        g.y0 + (tap >> 1) - 1 + r, g.img);
          }
          tma_load_2d(at + A_BYTES, &wmap, &full[st], c0,
                      (g.ph * NTAP + tap) * a.Co + g.nb * BN);
          if (++st == STAGES) st = 0, phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int w = tid / 128 - 1, warp = tid / 32 % 4, lane = tid % 32;
    const int row0 = BM == 128 ? 64 * w : 0;  // this consumer's A rows
    const int col0 = BM == 128 ? 0 : WN * w;  // and B rows (columns)
    const int sw = 2 * kb;                    // swizzle: a row's bytes
    bf16* __restrict__ out = static_cast<bf16*>(a.out);
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
    int st = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const GemmTile g = gemm_tile<BM, BN>(a, t);
      int prev = 0;
      for (int k = 0; k < KT; ++k) {
        mbar_wait(&full[st], phase);
        wgmma_fence();
        const unsigned char* at = ring + st * STAGE_BYTES;
        mma_step<WN>(acc, wgmma_desc(at + row0 * sw, sw),
                     wgmma_desc(at + A_BYTES + col0 * sw, sw), kb, k == 0);
        if (k > 0) {
          wgmma_wait<1>();  // step k - 1's products are done
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = st;
        if (++st == STAGES) st = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // acc[4j + 2h + e]: tile row row0 + 16 warp + lane / 4 + 8h, that
      // is tile row y0 + row0 / 16 + warp and column x0 + lane / 4 + 8h;
      // channel n0 + col0 + 8j + 2 (lane % 4) + e.
      const int r = g.ph >> 1, s = g.ph & 1;
      const int y = g.y0 + row0 / 16 + warp;
      const int cn = g.nb * BN + col0 + 2 * (lane & 3);
      if (y < a.Hp) {
        __nv_bfloat162 bz[WN / 8];
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
          bz[j] = __floats2bfloat162_rn(__ldg(a.bias + cn + 8 * j),
                                        __ldg(a.bias + cn + 8 * j + 1));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = g.x0 + (lane >> 2) + 8 * h;
          if (x >= a.Wp) continue;
          const int m = (g.img * a.Hp + y) * a.Wp + x;
          bf16* o = out + out_offset<MODE>(a, m, r, s) + cn;
#pragma unroll
          for (int j = 0; j < WN / 8; ++j) {
            const __nv_bfloat162 v = __hadd2(
                __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]),
                bz[j]);
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = mish2(v);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int GF_BM = 64, GF_BN = 64, GF_BK = 16;

template <int MODE>
__global__ void __launch_bounds__(GEMM_THREADS)
conv_gemm_f32_kernel(const ConvArgs a) {
  constexpr int NTAP = conv_taps<MODE>();
  __shared__ __align__(16) float As[GF_BK][GF_BM + 4];  // [k][m]
  __shared__ __align__(16) float Bs[GF_BK][GF_BN];      // [k][n]

  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ w = static_cast<const float*>(a.w);
  const int m0 = blockIdx.x * GF_BM, n0 = blockIdx.y * GF_BN;
  const int ph = blockIdx.z, r = ph >> 1, s = ph & 1;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool vec = a.Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  // The A row this thread loads (4 channels of one position) and the B
  // row (4 output channels of one input channel).
  const int arow = tid / 4, ac = (tid % 4) * 4;
  const int bk = tid / 16, bn = (tid % 16) * 4;
  const int m = m0 + arow;
  const int axq = m % a.Wp, ayq = m < a.M ? m / a.Wp % a.Hp : -(1 << 20);
  const float* xb = x + (size_t)(m < a.M ? m / (a.Wp * a.Hp) : 0) * a.H *
                            a.W * a.Cin;

  const int kc = a.cip / GF_BK, KT = NTAP * kc;
  float4 ra, rb;
  auto load = [&](int kt) {
    const int t = kt / kc, c = (kt % kc) * GF_BK;
    int iy, ix;
    const bool in = tap_pixel<MODE>(a, ayq, axq, t, r, s, iy, ix) &&
                    c + ac < a.Cin;
    const float* src = in ? xb + ((size_t)iy * a.W + ix) * a.Cin + c + ac : x;
    if (vec) {
      ra = in ? __ldg(reinterpret_cast<const float4*>(src))
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = in && c + ac + k < a.Cin ? __ldg(src + k) : 0.0f;
      ra = make_float4(v[0], v[1], v[2], v[3]);
    }
    rb = __ldg(reinterpret_cast<const float4*>(
        w + ((size_t)(ph * NTAP + t) * a.cip + c + bk) * a.Co + n0 + bn));
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load(0);
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();  // the previous step's reads are done
    As[ac + 0][arow] = ra.x;
    As[ac + 1][arow] = ra.y;
    As[ac + 2][arow] = ra.z;
    As[ac + 3][arow] = ra.w;
    *reinterpret_cast<float4*>(&Bs[bk][bn]) = rb;
    __syncthreads();
    if (kt + 1 < KT) load(kt + 1);  // in flight under the products
#pragma unroll
    for (int k = 0; k < GF_BK; ++k) {
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }

  float* __restrict__ out = static_cast<float*>(a.out);
  const int n = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mi = m0 + ty + 16 * i;
    if (mi >= a.M) continue;
    float* o = out + out_offset<MODE>(a, mi, r, s) + n;
    float4 v;
    v.x = mish<float>(acc[i][0] + __ldg(a.bias + n));
    v.y = mish<float>(acc[i][1] + __ldg(a.bias + n + 1));
    v.z = mish<float>(acc[i][2] + __ldg(a.bias + n + 2));
    v.w = mish<float>(acc[i][3] + __ldg(a.bias + n + 3));
    *reinterpret_cast<float4*>(o) = v;
  }
}

// ---------------------------------------------------------------- launch

// Shared-memory opt-in of one instantiation, once a device (bit per
// device; the opt-in costs microseconds of host time a call).
template <class K>
cudaError_t gemm_opt_in(K kern, size_t smem, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// The current device's SM count, asked once a device.
inline cudaError_t gemm_sm_count(int& n_sm) {
  static std::atomic<int> known[32];  // by device; 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  n_sm = dev < 32 ? known[dev].load(std::memory_order_relaxed) : 0;
  if (n_sm > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 32)
    known[dev].store(n_sm, std::memory_order_relaxed);
  return err;
}

// The tensor maps of one layer (see conv_gemm_wgmma_kernel), encoded for
// every call (the data pointers change), and a persistent launch: one
// block an SM, or a block a tile where there are fewer tiles.
template <int MODE, int BM, int BN>
cudaError_t launch_gemm_wgmma(const ConvArgs& a, int n_sm,
                              cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  auto kern = conv_gemm_wgmma_kernel<MODE, BM, BN>;
  constexpr size_t smem = gemm_smem<BM, BN>();
  cudaError_t err = gemm_opt_in(kern, smem, done);
  if (err != cudaSuccess) return err;
  const int kb = gemm_kb(a.Cin), sw = 2 * kb;
  const cuuint64_t C = a.Cin, W = a.W, H = a.H, n_img = a.M / (a.Hp * a.Wp);
  const cuuint64_t e = sizeof(bf16);
  CUtensorMap xm, wm;
  if constexpr (MODE == CONV_S2) {
    const cuuint64_t dims[5] = {2 * C, W / 2, 2, H / 2, n_img};
    const cuuint64_t strides[4] = {2 * C * e, W * C * e, 2 * W * C * e,
                                   H * W * C * e};
    const cuuint32_t box[5] = {(cuuint32_t)kb, 16, 1, BM / 16, 1};
    err = encode_bf16_map(&xm, a.x, 5, dims, strides, box, sw);
  } else {
    const cuuint64_t dims[4] = {C, W, H, n_img};
    const cuuint64_t strides[3] = {C * e, W * C * e, H * W * C * e};
    const cuuint32_t box[4] = {(cuuint32_t)kb, 16, BM / 16, 1};
    err = encode_bf16_map(&xm, a.x, 4, dims, strides, box, sw);
  }
  if (err != cudaSuccess) return err;
  const cuuint64_t slots = conv_taps<MODE>() * (MODE == CONV_UP ? 4 : 1);
  const cuuint64_t wdims[2] = {(cuuint64_t)a.cip, slots * a.Co};
  const cuuint64_t wstrides[1] = {(cuuint64_t)a.cip * e};
  const cuuint32_t wbox[2] = {(cuuint32_t)kb, BN};
  err = encode_bf16_map(&wm, a.w, 2, wdims, wstrides, wbox, sw);
  if (err != cudaSuccess) return err;
  const int tiles = gemm_tiles<MODE, BM, BN>(a);
  kern<<<tiles < n_sm ? tiles : n_sm, GW_THREADS, smem, stream>>>(xm, wm, a);
  return cudaGetLastError();
}

// One layer, T = float (CUDA cores, 64 x 64 tiles) or bf16 (wgmma, BN
// output channels a tile, BN = 64 or 128 as the caller's widths need).
// bf16 tiles are 128 positions, or (BN 128) 64 where 128-position tiles
// would leave half the SMs or more idle (measured: 64-row tiles win
// there and lose wherever 128-row tiles fill more than half a wave, as
// at the headline's stage 4; PERF.md holds the figures). Co must
// be a multiple of 64 (bf16: of BN); bf16 needs Cin a multiple of GEMM_K
// (cip = Cin) and x 16-byte aligned, as TMA and the stride-2 view do: the
// wrappers make an aligned, channel-padded copy of other inputs.
template <int MODE, typename T, int BN>
cudaError_t launch_conv_gemm(const ConvArgs& a, cudaStream_t stream) {
  const int nph = MODE == CONV_UP ? 4 : 1;
  if (a.Co % 64 || a.cip % GEMM_K || a.M < 1) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((a.M + GF_BM - 1) / GF_BM, a.Co / GF_BN, nph);
    conv_gemm_f32_kernel<MODE><<<grid, GEMM_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  } else {
    if (a.Co % BN || a.Cin % GEMM_K || a.cip != a.Cin ||
        reinterpret_cast<uintptr_t>(a.x) % 16)
      return cudaErrorInvalidValue;
    int n_sm = 0;
    const cudaError_t err = gemm_sm_count(n_sm);
    if (err != cudaSuccess) return err;
    if constexpr (BN == 128) {
      if (2 * gemm_tiles<MODE, 128, BN>(a) <= n_sm)
        return launch_gemm_wgmma<MODE, 64, BN>(a, n_sm, stream);
    }
    return launch_gemm_wgmma<MODE, 128, BN>(a, n_sm, stream);
  }
}

}  // namespace qpw
