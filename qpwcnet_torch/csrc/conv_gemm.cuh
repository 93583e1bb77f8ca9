// One convolution layer + bias + Mish as an implicit GEMM, one launch a
// layer: the bodies of K2 (stem.cu) and K5 (upconv.cu) at the widths whose
// weights do not fit in a block's shared memory (encoder stages 3-4,
// decoder stages 0-1, and the float32 stages from Co 64 on).
//
//   out[m][n] = Mish(bias[n] + sum_{tap, ci} x[pixel(m, tap)][ci] * W[tap][n][ci])
//
// M = positions, N = Co, K = taps x Cin. Three modes:
//  - CONV_S2: a 3x3 stride-2 SAME conv on an even input: position (y, x)
//    of the (H/2, W/2) output reads x[2y + dy, 2x + dx], dy, dx in 0..2,
//    zero at row H / column W (SAME pads (0, 1));
//  - CONV_S1: a 3x3 stride-1 SAME conv: x[y + dy - 1, x + dx - 1];
//  - CONV_UP: one output phase (r, s) = (blockIdx.z / 2, blockIdx.z % 2)
//    of the 4x4 stride-2 transpose conv: position (i, j) of the input
//    reads its 4 taps x[i + a - 1 + r, j + b - 1 + s], a, b in 0..1, and
//    writes output pixel (2i + r, 2j + s).
// Pixels outside the image read zero.
//
// The weights come prepared by the caller's source (stem.cu:prep_w33,
// upconv.cu:prep_wt) from the stored float32 layout, rounded to the
// compute dtype, in a scratch buffer the wrapper allocates:
// [phase x tap][Co][cip] bf16 for the tensor cores (ci contiguous: B's
// column-major fragment) and [phase x tap][cip][Co] float32 for the CUDA
// cores, cip = Cin rounded up to GEMM_K (zeros past Cin).
//
// Rounding points: the sum is taken in float32; bf16 rounds it, adds the
// bias rounded to bf16 and applies Mish in bf16 (common.cuh:mish2), as
// the unfused composition does; float32 adds the bias and applies Mish in
// float32.
//
// What bounds it on the H100: at the encoder's stages 3-4 and the
// decoder's stages 0-1 a layer does 2 x 9 (or 4) x Cin multiply-adds per
// output value against ~2 bytes of input and output each: 300-2300
// operations a byte, above the bf16 tensor cores' ridge (~295), so the
// operations bound it.
//
// bfloat16 body (conv_gemm_mma_kernel<MODE, BM, BN>): BM positions x BN
// output channels a block, 8 warps as 2 (M) x 4 (N), each warp
// BM/2 x BN/4 in float32 accumulators on mma.sync m16n8k16 (bf16
// operands by ldmatrix). K runs over (tap, 32-channel slice) steps; each
// step's A tile (the BM positions' pixels for that tap, gathered by row:
// no im2col) and B tile are copied by 16-byte cp.async into a
// three-stage ring (rows of 32 + 8 bf16: an odd number of 16-byte units,
// so ldmatrix's eight row reads fall in distinct banks) while the
// tensor cores work on the step before. BN is 128 (K2's widths, K5's Co
// 128) or 64 (K5's Co 64); BM is 128, or 64 where 128-row tiles would
// not cover the SMs. The two intermediates of a K2 stage go
// through device memory (a stage-4 intermediate at batch 16 is 3.7 MB:
// it stays in the 50 MB L2).
// float32 body (conv_gemm_f32_kernel<MODE>): CUDA-core FMAs (TF32 would
// break the 1e-5 equality with the plain version), 64 x 64 a block of
// 256 threads, each 4 positions x 4 channels, K in 16-channel steps
// through shared memory, the next step's loads in registers meanwhile.
#pragma once

#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace qpw {

enum { CONV_S2 = 0, CONV_S1 = 1, CONV_UP = 2 };

constexpr int GEMM_K = 32;            // channels a K step (cip's multiple)
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

constexpr int GM_STAGES = 3;
constexpr int GM_LDS = GEMM_K + 8;    // a tile row, bf16

template <int BM, int BN>
__host__ __device__ constexpr size_t gemm_mma_smem() {
  return (size_t)GM_STAGES * (BM + BN) * GM_LDS * 2;
}

template <int MODE, int BM, int BN>
__global__ void __launch_bounds__(GEMM_THREADS)
conv_gemm_mma_kernel(const ConvArgs a) {
  constexpr int NTAP = conv_taps<MODE>();
  constexpr int WM = BM / 2, WN = BN / 4;    // a warp's tile
  constexpr int MT = WM / 16, NT = WN / 8;   // its m16 and n8 tiles
  constexpr int ACH = BM * 4 / GEMM_THREADS; // 16-byte A chunks a thread
  constexpr int BCH = BN * 4 / GEMM_THREADS; // and B chunks
  static_assert(ACH >= 1 && BCH >= 1 && NT % 2 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char gm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gm_smem);    // [STAGES][BM][LDS]
  bf16* Bs = As + GM_STAGES * BM * GM_LDS;        // [STAGES][BN][LDS]

  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const bf16* __restrict__ w = static_cast<const bf16*>(a.w);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, ph = blockIdx.z;
  const int r = ph >> 1, s = ph & 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const bool vec = a.Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  // This thread's A rows: position, image, row and column, once.
  int ay[ACH], ax[ACH];
  const bf16* ab[ACH];
#pragma unroll
  for (int i = 0; i < ACH; ++i) {
    const int m = m0 + (tid + i * GEMM_THREADS) / 4;
    const int xq = m % a.Wp, yq = m / a.Wp % a.Hp, b = m / (a.Wp * a.Hp);
    ay[i] = m < a.M ? yq : -(1 << 20);  // off every image: reads zero
    ax[i] = xq;
    ab[i] = x + (size_t)(m < a.M ? b : 0) * a.H * a.W * a.Cin;
  }

  const int kc = a.cip / GEMM_K, KT = NTAP * kc;
  auto load = [&](int kt, int st) {
    const int t = kt / kc, c0 = (kt % kc) * GEMM_K;
#pragma unroll
    for (int i = 0; i < ACH; ++i) {
      const int e = tid + i * GEMM_THREADS, row = e / 4, c = c0 + (e % 4) * 8;
      int iy, ix;
      const bool in = tap_pixel<MODE>(a, ay[i], ax[i], t, r, s, iy, ix) &&
                      c < a.Cin;
      const bf16* src = in ? ab[i] + ((size_t)iy * a.W + ix) * a.Cin + c : x;
      bf16* dst = As + (st * BM + row) * GM_LDS + (e % 4) * 8;
      if (vec) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
        __align__(16) unsigned short v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = in && c + k < a.Cin ? __bfloat16_as_ushort(src[k]) : 0;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
#pragma unroll
    for (int i = 0; i < BCH; ++i) {
      const int e = tid + i * GEMM_THREADS, row = e / 4, c = (e % 4) * 8;
      cp_async16(Bs + (st * BN + row) * GM_LDS + c,
                 w + ((size_t)(ph * NTAP + t) * a.Co + n0 + row) * a.cip +
                     c0 + c,
                 16);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.0f;

#pragma unroll
  for (int st = 0; st < GM_STAGES - 1; ++st) {
    if (st < KT) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GM_STAGES - 2>();
    __syncthreads();  // step kt is in place; step kt - 1's slot is free
    const int nk = kt + GM_STAGES - 1;
    if (nk < KT) load(nk, nk % GM_STAGES);
    cp_async_commit();

    const int st = kt % GM_STAGES;
    // ldmatrix rows: A's lane l -> row l % 16, channels +8 for l >= 16;
    // B's lane l -> co (l / 16) * 8 + l % 8 of a 16-wide pair, channels
    // +8 for odd l / 8.
    const bf16* at = As + (st * BM + wm * WM + (lane & 15)) * GM_LDS +
                     (lane >> 4) * 8;
    const bf16* bt = Bs + (st * BN + wn * WN + (lane >> 4) * 8 + (lane & 7)) *
                              GM_LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < GEMM_K; kk += 16) {
      uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], smem_addr(at + mt * 16 * GM_LDS + kk));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4(bfr[np], smem_addr(bt + np * 16 * GM_LDS + kk));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt / 2][2 * (nt & 1)],
                   bfr[nt / 2][2 * (nt & 1) + 1]);
    }
  }
  cp_async_wait<0>();

  // acc[mt][nt][k]: row wm*WM + mt*16 + lane/4 + 8 (k / 2), channel
  // wn*WN + nt*8 + 2 (lane % 4) + k % 2.
  bf16* __restrict__ out = static_cast<bf16*>(a.out);
  const int cn = n0 + wn * WN + 2 * (lane & 3);
  __nv_bfloat162 bz[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    bz[nt] = __floats2bfloat162_rn(__ldg(a.bias + cn + nt * 8),
                                   __ldg(a.bias + cn + nt * 8 + 1));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + mt * 16 + (lane >> 2) + 8 * h;
      if (m >= a.M) continue;
      bf16* o = out + out_offset<MODE>(a, m, r, s) + cn;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat162 y = __hadd2(
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]),
            bz[nt]);
        *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) = mish2(y);
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

template <int MODE, int BM, int BN>
cudaError_t launch_gemm_mma(const ConvArgs& a, int nph, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  auto kern = conv_gemm_mma_kernel<MODE, BM, BN>;
  constexpr size_t smem = gemm_mma_smem<BM, BN>();
  cudaError_t err = gemm_opt_in(kern, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + BM - 1) / BM, a.Co / BN, nph);
  kern<<<grid, GEMM_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// One layer, T = float (CUDA cores, 64 x 64 tiles) or bf16 (tensor
// cores, BN output channels a block, BN = 64 or 128 as the caller's
// widths need; BM = 128 where those tiles cover the SMs, else 64). Co
// must be a multiple of 64 (bf16: of BN).
template <int MODE, typename T, int BN>
cudaError_t launch_conv_gemm(const ConvArgs& a, cudaStream_t stream) {
  const int nph = MODE == CONV_UP ? 4 : 1;
  if (a.Co % 64 || a.cip % GEMM_K || a.M < 1) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((a.M + GF_BM - 1) / GF_BM, a.Co / GF_BN, nph);
    conv_gemm_f32_kernel<MODE><<<grid, GEMM_THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  } else {
    if (a.Co % BN) return cudaErrorInvalidValue;
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if ((long long)((a.M + 127) / 128) * (a.Co / BN) * nph >= n_sm)
      return launch_gemm_mma<MODE, 128, BN>(a, nph, stream);
    return launch_gemm_mma<MODE, 64, BN>(a, nph, stream);
  }
}

}  // namespace qpw
