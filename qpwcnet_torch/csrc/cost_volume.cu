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
// The bf16 body's tile configuration, staging, products and epilogue live
// in cv_mma.cuh, which K3's bf16 body (warp_cv.cu) shares.
//
// float32 body: correlate_kernel<float, false> (correlate.cuh) on the CUDA
// cores, so that float32 stays within 1e-5 of the plain version (TF32
// products would not).
#include <stdint.h>

#include <atomic>

#include "cv_mma.cuh"

namespace qpw {

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
  const int warp = threadIdx.x >> 5;
  const size_t plane = (size_t)H * W;
  const bf16* const pb = prv + (size_t)b * plane * C;
  const bf16* const nb = nxt + (size_t)b * plane * C;
  const int n_chunks = (C + CM_CC - 1) / CM_CC;

  const int ty = warp % TY, di0 = warp / TY * Cfg::DI;
  float acc[Cfg::DI][2][4];
#pragma unroll
  for (int d = 0; d < Cfg::DI; ++d)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[d][j][r] = 0.0f;

  // the window's pixels and the prv tile's, a two-stage ring of chunks
  cm_stage<TY, DG>(nb, pb, stages, 0, 0, Cfg::PIX, x0, y0, H, W, C, vec);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const bf16* buf = stages + (ch & 1) * Cfg::STAGE;
    if (ch + 1 < n_chunks) {
      cm_stage<TY, DG>(nb, pb, stages + ((ch + 1) & 1) * Cfg::STAGE,
                       (ch + 1) * CM_CC, 0, Cfg::PIX, x0, y0, H, W, C, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    cm_products<TY, DG>(acc, buf, ch, C, ty, di0);
    __syncthreads();
  }
  // the output tile takes stage 0's place (the loop ended on a barrier)
  cm_epilogue<TY, DG>(acc, stages, out, b, H, W, C, x0, y0, ty, di0);
}

template <int TY, int DG>
cudaError_t launch_cv_mma(const void* prv, const void* nxt, void* out,
                          int B, int H, int W, int C, cudaStream_t stream) {
  using Cfg = CmCfg<TY, DG>;
  auto kern = cost_volume_mma_kernel<TY, DG>;
  constexpr int max_smem = 2 * Cfg::STAGE * (int)sizeof(bf16);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the dynamic shared-memory limit, once a device (one bit each)
  static std::atomic<unsigned> limit_set{0};
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(limit_set.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
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

cudaError_t launch_cv_bf16(const void* prv, const void* nxt, void* out,
                           int B, int H, int W, int C, cudaStream_t stream) {
  cudaError_t err;
  switch (cm_tile_rows(B, H, W, &err)) {
    case 8: return launch_cv_mma<8, 1>(prv, nxt, out, B, H, W, C, stream);
    case 4: return launch_cv_mma<4, 3>(prv, nxt, out, B, H, W, C, stream);
    case 2: return launch_cv_mma<2, 9>(prv, nxt, out, B, H, W, C, stream);
    default: return err;
  }
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
