// The banded tensor-core correlation shared by K1's bf16 body
// (cost_volume.cu: cost_volume_mma_kernel) and K3's (warp_cv.cu:
// warp_cv_mma_kernel): the tile configuration, the staging of prv tiles
// (and of K1's nxt window) by cp.async, the mma.sync products of one
// chunk of channels, and the epilogue that rounds and stores each row's
// run. cost_volume.cu's note describes the design; the two kernels differ
// only in how the haloed window reaches shared memory.
#pragma once

#include <stdint.h>

#include "correlate.cuh"
#include "mma.cuh"

namespace qpw {

constexpr int CM_TX = 16;                // pixels of a warp's run
constexpr int CM_CC = 32;                // channels a stage
constexpr int CM_PS = CM_CC + 8;         // pixel stride in shared memory, bf16
constexpr int CM_WX = CM_TX + 2 * CV_R;  // 24 window columns
constexpr int CM_RUN = CM_TX * CV_K;     // 1296 outputs of a run
// A row's output slot in shared memory, bf16: the run shifted by up to 7
// elements to its global address mod 16, in 163 whole 16-byte units.
constexpr int CM_UNITS = (CM_RUN + 7 + 7) / 8;
constexpr int CM_OS = CM_UNITS * 8;

template <int TY, int DG>
struct CmCfg {
  static constexpr int DI = CV_D / DG;  // displacement rows a warp
  static constexpr int NT = TY * DG * 32;
  static constexpr int WIN = (TY + 2 * CV_R) * CM_WX;  // window pixels
  static constexpr int PIX = WIN + TY * CM_TX;         // staged pixels
  static constexpr int STAGE = PIX * CM_PS;            // bf16 a stage
  static_assert(CV_D % DG == 0, "DG divides the nine displacement rows");
  static_assert(TY * CM_OS <= STAGE, "the output tile fits in stage 0");
};

// Chunk c0 of staged pixels [lo, hi) into buf: the window's pixels (from
// nb) below WIN, the prv tile's (from pb) from WIN on, each 4 segments of
// 8 channels; zeros outside the image and past C. vec: 16-byte cp.async
// (C % 8 == 0 and both maps 16-byte aligned), else element loads. nh: the
// rows nb holds above (and below) the image, K1's haloed mode (nb is
// (H + 2 nh) x W, image row y at row y + nh; zeros only outside those
// rows); 0 for the plain mode and for K3, which stages only the prv tile
// here.
template <int TY, int DG>
__device__ __forceinline__ void cm_stage(const bf16* nb, const bf16* pb,
                                         bf16* buf, int c0, int lo, int hi,
                                         int x0, int y0, int H, int W, int C,
                                         int vec, int nh) {
  using Cfg = CmCfg<TY, DG>;
  for (int i = threadIdx.x + lo * 4; i < hi * 4; i += Cfg::NT) {
    const int pix = i >> 2, c = c0 + (i & 3) * 8;
    int gy, gx, rows;
    const bf16* src;
    if (pix < Cfg::WIN) {
      gy = y0 - CV_R + nh + pix / CM_WX;
      gx = x0 - CV_R + pix % CM_WX;
      src = nb;
      rows = H + 2 * nh;
    } else {
      gy = y0 + (pix - Cfg::WIN) / CM_TX;
      gx = x0 + (pix - Cfg::WIN) % CM_TX;
      src = pb;
      rows = H;
    }
    const bool in = gy >= 0 && gy < rows && gx >= 0 && gx < W && c < C;
    const bf16* g = in ? src + ((size_t)gy * W + gx) * C + c : src;
    bf16* dst = buf + pix * CM_PS + (i & 3) * 8;
    if (vec) {
      cp_async16(dst, g, in ? 16 : 0);
    } else {
      unsigned short v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (in) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < C) v[e] = __bfloat16_as_ushort(g[e]);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          v[0] | (uint32_t)v[1] << 16, v[2] | (uint32_t)v[3] << 16,
          v[4] | (uint32_t)v[5] << 16, v[6] | (uint32_t)v[7] << 16);
    }
  }
}

// The products of chunk ch (staged in buf) into acc: a warp's output row
// ty, displacement rows di0 .. di0 + DI - 1. ldmatrix row addresses:
// lanes 0-7 and 8-15 give rows 0-7 at channel offsets 0 and 8, lanes
// 16-31 rows 8-15 likewise (x4); the x2 load of window columns 16-23 uses
// lanes 0-15 only.
template <int TY, int DG>
__device__ __forceinline__ void cm_products(
    float (&acc)[CmCfg<TY, DG>::DI][2][4], const bf16* buf, int ch, int C,
    int ty, int di0) {
  using Cfg = CmCfg<TY, DG>;
  const int lane = threadIdx.x & 31;
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lk = ((lane >> 3) & 1) * 8;
  const uint32_t win = smem_addr(buf);
  const uint32_t pv = smem_addr(buf + Cfg::WIN * CM_PS);
#pragma unroll
  for (int ks = 0; ks < CM_CC / 16; ++ks) {
    if (ch * CM_CC + ks * 16 >= C) break;
    // B: pixels 0-7 (b0, b1 of tile 0) and 8-15 (tile 1), k16 step ks
    uint32_t bq[4];
    ldmatrix_x4(bq, pv + ((ty * CM_TX + lrow) * CM_PS + ks * 16 + lk) * 2);
#pragma unroll
    for (int d = 0; d < Cfg::DI; ++d) {
      const uint32_t row =
          win + (((ty + di0 + d) * CM_WX) * CM_PS + ks * 16 + lk) * 2;
      // window columns 0-7, 8-15 (x4: k 0-7 and 8-15 of each), 16-23 (x2)
      uint32_t a4[4], a2[2];
      ldmatrix_x4(a4, row + lrow * CM_PS * 2);
      ldmatrix_x2(a2, row + (16 + (lane & 7)) * CM_PS * 2);
      const uint32_t t0[4] = {a4[0], a4[2], a4[1], a4[3]};
      const uint32_t t1[4] = {a4[2], a2[0], a4[3], a2[1]};
      mma_bf16(acc[d][0], t0, bq[0], bq[1]);
      mma_bf16(acc[d][1], t1, bq[2], bq[3]);
    }
  }
}

// Epilogue: the output tile takes the staging buffer's place (the caller
// has passed a barrier after its last products). A lane's sum r of tile j
// is window column q = g (+8 for r >= 2) against pixel p = 2t + (r & 1)
// of the tile. Each in-band sum is scaled by 1/C, leaky-ReLU'd in float32
// and rounded once to bf16 into a shared [16][81] row; each row's run is
// then stored, whole 16-byte units by vector stores, the partial units at
// its ends element by element.
template <int TY, int DG>
__device__ __forceinline__ void cm_epilogue(
    const float (&acc)[CmCfg<TY, DG>::DI][2][4], bf16* so, bf16* out, int b,
    int H, int W, int C, int x0, int y0, int ty, int di0) {
  using Cfg = CmCfg<TY, DG>;
  const int tid = threadIdx.x, lane = tid & 31;
  const uintptr_t out_el = reinterpret_cast<uintptr_t>(out) / 2;
  auto shift_of = [&](int y) {
    return (int)((out_el + (((size_t)b * H + y) * W + x0) * CV_K) % 8);
  };
  {
    bf16* orow = so + ty * CM_OS + shift_of(y0 + ty);
    const float inv_c = 1.0f / (float)C;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int d = 0; d < Cfg::DI; ++d)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = 2 * t + (r & 1), dj = g + (r & 2) * 4 - p;
          if (dj >= 0 && dj < CV_D) {
            const float a = acc[d][j][r] * inv_c;
            orow[(j * 8 + p) * CV_K + (di0 + d) * CV_D + dj] =
                __float2bfloat16_rn(a > 0.0f ? a : a * 0.1f);
          }
        }
  }
  __syncthreads();

  const int n_el = min(CM_TX, W - x0) * CV_K;
  for (int i = tid; i < TY * CM_UNITS; i += Cfg::NT) {
    const int row = i / CM_UNITS, u = i % CM_UNITS;
    const int y = y0 + row;
    if (y >= H) continue;
    const int lo = u * 8 - shift_of(y);  // first element of unit u
    if (lo >= n_el) continue;
    const bf16* s = so + row * CM_OS + u * 8;
    bf16* dst = out + (ptrdiff_t)((((size_t)b * H + y) * W + x0) * CV_K) + lo;
    if (lo >= 0 && lo + 8 <= n_el) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = max(0, -lo); e < 8 && lo + e < n_el; ++e) dst[e] = s[e];
    }
  }
}

// The launcher's tile rule: (TY, DG) = (8, 1) where its grid gives every
// SM two blocks, else (4, 3) where it gives every SM one, else (2, 9).
// Returns TY, or 0 with err set.
inline int cm_tile_rows(int B, int H, int W, cudaError_t* err) {
  int dev = 0, n_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  const long long runs = (long long)B * ((W + CM_TX - 1) / CM_TX);
  if (runs * ((H + 7) / 8) >= 2LL * n_sm) return 8;
  if (runs * ((H + 3) / 4) >= n_sm) return 4;
  return 2;
}

}  // namespace qpw
