// K1: the cost-volume forward,
//
//   out[b,y,x,k] = leaky_relu_0.1((1/C) sum_c prv[b,y,x,c] nxt[b,y+di,x+dj,c])
//
// di, dj in [-4, 4], k = (di+4)*9 + (dj+4), nxt zero outside the image;
// NHWC and contiguous. Replaces
// qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:_cv_kernel (via
// _cost_volume_pallas_impl).
//
// What bounds it on the H100: bytes. A pixel reads 2·C bf16 values and
// writes 81 (128 + 162 bytes at C = 32); the work is 81·C multiply-adds,
// 18 to 80 operations a byte over the model's levels, far under the bf16
// tensor cores' ridge (~295 a byte) but not under the CUDA cores' (~20).
// On the CUDA cores, with one pixel a thread, the shared-memory operand
// loads (one a multiply-add) cost ~5x the byte bound.
//
// bfloat16 body (cost_volume_mma_kernel): the correlation as banded dense
// products on the tensor cores, mma.sync m16n8k16 with bf16 operands and
// float32 sums, operands by ldmatrix.
//  - The band. For one output row y, 8 pixels x0..x0+7 and one
//    displacement row di, the nine dj of all 8 pixels are the band
//    0 <= q - p <= 8 of one 16 x 8 product over the channels,
//      A[q][c] = nxt[y+di, x0-4+q, c]   (16 window columns: M)
//      B[c][p] = prv[y, x0+p, c]         (8 pixels: N),
//    with k = (di+4)*9 + (q - p): 72 of its 128 values are used. Pixels
//    on N and the window on M take one mma for 8 pixels; pixels on M
//    (16 x 24 window columns) would take three for 16 (37.5% used).
//  - Both operands are [pixel][channel] rows in shared memory, so A
//    (row-major) and B (column-major) load by ldmatrix without .trans.
//    A warp owns a run of 16 pixels of one output row (two n8 tiles,
//    which share 8 window columns): per displacement row and k16 step it
//    loads the 24 window columns once (ldmatrix x4 + x2) and runs 2 mma.
//  - A block takes TY output rows x 16 pixels with DG warps a row, each
//    warp DI = 9 / DG of the nine displacement rows (2·DI·4 float sums a
//    lane). Per chunk of 32 channels it stages its prv tile (TY x 16
//    pixels) and the haloed nxt window ((TY+8) x 24 pixels, whose rows
//    serve all TY output rows) by 16-byte cp.async, zero-filled outside
//    the image and past C, in a two-stage ring: the next chunk's copies
//    are in flight while this chunk's mma run. The pixel stride is 40
//    bf16 (80 bytes, an odd number of 16-byte units), so ldmatrix's eight
//    row reads fall in distinct banks. Where C % 8 != 0 a pixel row is not
//    16-byte aligned, and the same ring is filled by guarded element
//    loads. At C <= 32 a block is one chunk and one stage of shared
//    memory.
//  - Three tile shapes (TY, DG) = (8, 1), (4, 3), (2, 9), of 8, 12 and
//    18 warps: the launcher takes (8, 1) where its grid gives every SM two
//    blocks, else (4, 3) where it gives every SM one, else (2, 9), so the
//    coarse levels (14 x 32 pixels, C = 256, batch 8: 224 runs of 16)
//    still spread over the 132 SMs. The channel sum is never split across
//    blocks: leaky ReLU needs all of it. (A persistent grid whose ring
//    ran across tiles, so that a block's next tile loaded under this
//    one's products and stores, measured no faster at C = 32 and slower
//    at the coarse levels.)
//  - Epilogue: each lane scales its in-band sums by 1/C, applies leaky
//    ReLU in float32 and rounds once to bf16 (the plain version's rounding
//    points, ops/cost_volume.py:cost_volume_plain) into a shared [16][81]
//    tile a row, in stage 0's place; the block then stores each row's
//    run, 16 x 162 = 2592 contiguous bytes of NHWC, by 16-byte stores. The
//    shared row starts at its global run's address mod 16, so every whole
//    16-byte unit is one vector copy whatever W and x0 are.
// Against the TPU kernel: _cv_kernel rounds each product prv * roi to bf16
// before its float32 sum; this body and the plain version sum exact
// products. The two differ by 4.9e-4 at (2,9,37,20) for max|out| 1.05 (a
// sixteenth of a bf16 ulp there; tests/test_torch_kernels_plain.py).
//
// float32 body: correlate_kernel<float, false> (correlate.cuh) on the CUDA
// cores, so that float32 stays within 1e-5 of the plain version (TF32
// products would not).
#include <stdint.h>

#include <atomic>

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

template <int TY, int DG>
__global__ void __launch_bounds__(CmCfg<TY, DG>::NT, 2)
cost_volume_mma_kernel(const bf16* __restrict__ prv,
                       const bf16* __restrict__ nxt, bf16* __restrict__ out,
                       int H, int W, int C, int vec) {
  using Cfg = CmCfg<TY, DG>;
  extern __shared__ __align__(16) unsigned char cm_smem[];
  bf16* const stages = reinterpret_cast<bf16*>(cm_smem);

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * CM_TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t plane = (size_t)H * W;
  const bf16* const pb = prv + (size_t)b * plane * C;
  const bf16* const nb = nxt + (size_t)b * plane * C;
  const int n_chunks = (C + CM_CC - 1) / CM_CC;

  // Chunk ch into buf: the window's pixels, then the prv tile's, each 4
  // segments of 8 channels; zeros outside the image and past C.
  auto stage = [&](int ch, bf16* buf) {
    const int c0 = ch * CM_CC;
    for (int i = tid; i < Cfg::PIX * 4; i += Cfg::NT) {
      const int pix = i >> 2, c = c0 + (i & 3) * 8;
      int gy, gx;
      const bf16* src;
      if (pix < Cfg::WIN) {
        gy = y0 - CV_R + pix / CM_WX;
        gx = x0 - CV_R + pix % CM_WX;
        src = nb;
      } else {
        gy = y0 + (pix - Cfg::WIN) / CM_TX;
        gx = x0 + (pix - Cfg::WIN) % CM_TX;
        src = pb;
      }
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
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
  };

  const int ty = warp % TY, di0 = warp / TY * Cfg::DI;
  // ldmatrix row addresses: lanes 0-7 and 8-15 give rows 0-7 at channel
  // offsets 0 and 8, lanes 16-31 rows 8-15 likewise (x4); the x2 load of
  // window columns 16-23 uses lanes 0-15 only.
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lk = ((lane >> 3) & 1) * 8;
  float acc[Cfg::DI][2][4];
#pragma unroll
  for (int d = 0; d < Cfg::DI; ++d)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[d][j][r] = 0.0f;

  stage(0, stages);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const bf16* buf = stages + (ch & 1) * Cfg::STAGE;
    if (ch + 1 < n_chunks) {
      stage(ch + 1, stages + ((ch + 1) & 1) * Cfg::STAGE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
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
    __syncthreads();
  }

  // Epilogue: the output tile takes stage 0's place (the loop ended on a
  // barrier). A lane's sum r of tile j is window column q = g (+8 for
  // r >= 2) against pixel p = 2t + (r & 1) of the tile.
  bf16* const so = stages;
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

  // Each row's run: whole 16-byte units by vector stores, the partial
  // units at its ends element by element.
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

template <int TY, int DG>
cudaError_t launch_cv_mma(const void* prv, const void* nxt, void* out,
                          int B, int H, int W, int C, int dev,
                          cudaStream_t stream) {
  using Cfg = CmCfg<TY, DG>;
  auto kern = cost_volume_mma_kernel<TY, DG>;
  constexpr int max_smem = 2 * Cfg::STAGE * (int)sizeof(bf16);
  // the dynamic shared-memory limit, once a device (one bit each)
  static std::atomic<unsigned> limit_set{0};
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(limit_set.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return err;
    limit_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const int ny = (H + TY - 1) / TY;
  if (ny > 65535 || B > 65535) return cudaErrorInvalidValue;
  // one stage where one chunk holds all channels
  const size_t smem = (C > CM_CC ? 2 : 1) * Cfg::STAGE * sizeof(bf16);
  const int vec = C % 8 == 0 && ((reinterpret_cast<uintptr_t>(prv) |
                                  reinterpret_cast<uintptr_t>(nxt)) %
                                 16) == 0;
  kern<<<dim3((W + CM_TX - 1) / CM_TX, ny, B), Cfg::NT, smem, stream>>>(
      static_cast<const bf16*>(prv), static_cast<const bf16*>(nxt),
      static_cast<bf16*>(out), H, W, C, vec);
  return cudaGetLastError();
}

// (8, 1) where its grid gives every SM two blocks, else (4, 3) where it
// gives every SM one, else (2, 9).
cudaError_t launch_cv_bf16(const void* prv, const void* nxt, void* out,
                           int B, int H, int W, int C, cudaStream_t stream) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long runs = (long long)B * ((W + CM_TX - 1) / CM_TX);
  if (runs * ((H + 7) / 8) >= 2LL * n_sm)
    return launch_cv_mma<8, 1>(prv, nxt, out, B, H, W, C, dev, stream);
  if (runs * ((H + 3) / 4) >= n_sm)
    return launch_cv_mma<4, 3>(prv, nxt, out, B, H, W, C, dev, stream);
  return launch_cv_mma<2, 9>(prv, nxt, out, B, H, W, C, dev, stream);
}

}  // namespace qpw

extern "C" int qpw_cost_volume(const void* prv, const void* nxt, void* out,
                               int B, int H, int W, int C, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || C < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return qpw::launch_correlate<float, false>(prv, nxt, nullptr, out, B, H,
                                               W, C, 0.0f, s);
  if (dtype == 1) return qpw::launch_cv_bf16(prv, nxt, out, B, H, W, C, s);
  return cudaErrorInvalidValue;
}
