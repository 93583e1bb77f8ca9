// K3: the fused warp + correlate,
//
//   out[b,y,x,k] = leaky_relu_0.1((1/C) sum_c prv[b,y,x,c] Wp[b,y+di,x+dj,c])
//
// with Wp = backward_warp(nxt, clamp(flow, +-ww)): zero outside the image,
// inside it the border-clamped bilinear sample of nxt (corner origin
// clamped to [0, size-2], weights to [0, 1]) at the flow of THAT pixel;
// di, dj in [-4, 4], k = (di+4)*9 + (dj+4); NHWC and contiguous, flow
// (B, H, W, 2) float32 in (x, y) order. The warped map never reaches
// device memory. Replaces
// qpwcnet_tpu/ops/pallas/warp_cv_kernel.py:_wcv_kernel (via
// warp_cost_volume_pallas).
//
// What bounds it on the H100: bytes, as K1 (cost_volume.cu): a pixel reads
// 2·C bf16 values and 8 flow bytes and writes 81 bf16; the bilinear gather
// adds 4 corner reads of the window per output, which hit L1/L2 (the
// corners of neighbouring pixels overlap), and ~9 bf16-rounded operations
// per channel.
//
// bfloat16 body (warp_cv_mma_kernel): K1's banded tensor-core products,
// epilogue and stores (cv_mma.cuh), with the haloed window produced by a
// gather instead of a copy:
//  - Once a tile: each of the (TY+8) x 24 window pixels' clamped corner
//    origin and its two weights (rounded to bf16, as the plain version
//    casts them to the image dtype) from the float32 flow at that window
//    pixel; -1 marks a window pixel outside the image (zeros). The prv
//    tile's cp.async copies are issued first and are in flight meanwhile.
//  - Per 32-channel chunk each thread takes (window pixel, 8-channel
//    segment) items, two at a time: it issues the four corners' 16-byte
//    loads (8 contiguous channels of NHWC at base, base+1, base+W,
//    base+W+1) of both items before using any, interpolates two channels
//    an instruction with bf16x2 sub, mul and add, each rounded to nearest
//    once (.rn, so never fused into a multiply-add), and writes the 8
//    results as one 16-byte shared store into the window's
//    [pixel][channel] row. For bf16 operands a correctly rounded bf16
//    result is what eager PyTorch computes (the float32 result rounded to
//    bf16), so the window holds exactly the plain version's warped map,
//    and the products and float32 sums are K1's: one bf16 ulp of the
//    plain version. (Interpolating in float32 with a rounding after every
//    operation gives the same bits with more instructions.)
//  - Chunk 0, the only one at the main paths' C = 32, is gathered before
//    the 72 float32 sums of a lane are live, so that its 32 registers of
//    loads in flight do not spill them. One stage of shared memory: the
//    gather's latency is hidden by the loads in flight and two blocks an
//    SM, not by a ring.
//  - K1's tile rule picks (TY, DG) = (8, 1), (4, 3) or (2, 9) by the
//    grid's size ((2, 9) for grids of fewer blocks than SMs, one block an
//    SM). Where C % 8 != 0 or a map is not 16-byte aligned, the gather and
//    the prv tile use guarded element loads: every bf16 call runs on the
//    tensor cores.
//
// float32 body: correlate_kernel<float, true> (correlate.cuh) on the CUDA
// cores, so that float32 stays within 1e-5 of the plain version (TF32
// products would not).
#include <stdint.h>

#include "cv_mma.cuh"

namespace qpw {

// Each window pixel's corner origin y0 * W + x0 (-1 outside the image)
// and weights, from the flow at that pixel clamped to +-ww
// (ops/warp.py:warp_coords); each weight rounded to bf16, as the plain
// version casts it to the image dtype, in both halves of a word.
template <int TY, int DG>
__device__ __forceinline__ void wcv_corners(const float* fb, int* corner,
                                            uint32_t* wax, uint32_t* way,
                                            int x0, int y0, int H, int W,
                                            float ww) {
  using Cfg = CmCfg<TY, DG>;
  for (int p = threadIdx.x; p < Cfg::WIN; p += Cfg::NT) {
    const int gy = y0 - CV_R + p / CM_WX;
    const int gx = x0 - CV_R + p % CM_WX;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      corner[p] = -1;
      continue;
    }
    const float* f = fb + ((size_t)gy * W + gx) * 2;
    const float qx = (float)gx + fminf(fmaxf(f[0], -ww), ww);
    const float qy = (float)gy + fminf(fmaxf(f[1], -ww), ww);
    const float fx0 = fminf(fmaxf(floorf(qx), 0.0f), (float)(W - 2));
    const float fy0 = fminf(fmaxf(floorf(qy), 0.0f), (float)(H - 2));
    corner[p] = (int)fy0 * W + (int)fx0;
    const float ax = fminf(fmaxf(qx - fx0, 0.0f), 1.0f);
    const float ay = fminf(fmaxf(qy - fy0, 0.0f), 1.0f);
    const __nv_bfloat162 a2 = __floats2bfloat162_rn(ax, ax);
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(ay, ay);
    wax[p] = *reinterpret_cast<const uint32_t*>(&a2);
    way[p] = *reinterpret_cast<const uint32_t*>(&b2);
  }
}

// The four corners' 8 channels [c, c + 8) of one item (zeros past C; the
// caller has checked that the pixel is inside the image and c < C).
__device__ __forceinline__ void wcv_load(const bf16* g, size_t row, int c,
                                         int C, int vec, uint4 (&q)[4]) {
  const bf16* const at[4] = {g, g + C, g + row, g + row + C};
  if (vec) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[k] = __ldg(reinterpret_cast<const uint4*>(at[k]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned short v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < C) v[e] = __bfloat16_as_ushort(at[k][e]);
      q[k] = make_uint4(
          v[0] | (uint32_t)v[1] << 16, v[2] | (uint32_t)v[3] << 16,
          v[4] | (uint32_t)v[5] << 16, v[6] | (uint32_t)v[7] << 16);
    }
  }
}

// bf16x2 a - b, a * b, a + b, each rounded to nearest once (.rn: never
// fused into a multiply-add).
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two channels (one 32-bit word of each corner) interpolated as the plain
// version does, top = g00 + (g01 - g00) ax, bot likewise, top + (bot -
// top) ay, each operation rounded to bf16. A bf16x2 instruction gives the
// correctly rounded result, which is eager PyTorch's float32 result
// rounded to bf16: a product of two bf16 values is exact in float32, and
// a float32 sum of two rounds only where the smaller is far below half a
// bf16 ulp of the larger, which both roundings then drop.
__device__ __forceinline__ uint32_t wcv_lerp2(uint32_t g00, uint32_t g01,
                                              uint32_t g10, uint32_t g11,
                                              uint32_t ax, uint32_t ay) {
  const uint32_t top = badd2(g00, bmul2(bsub2(g01, g00), ax));
  const uint32_t bot = badd2(g10, bmul2(bsub2(g11, g10), ax));
  return badd2(top, bmul2(bsub2(bot, top), ay));
}

__device__ __forceinline__ uint4 wcv_lerp8(const uint4 (&q)[4], uint32_t ax,
                                           uint32_t ay) {
  return make_uint4(wcv_lerp2(q[0].x, q[1].x, q[2].x, q[3].x, ax, ay),
                    wcv_lerp2(q[0].y, q[1].y, q[2].y, q[3].y, ax, ay),
                    wcv_lerp2(q[0].z, q[1].z, q[2].z, q[3].z, ax, ay),
                    wcv_lerp2(q[0].w, q[1].w, q[2].w, q[3].w, ax, ay));
}

// The warped window of chunk c0 into buf's first WIN pixel rows: items i
// and i + NT of a thread, their 8 corner loads issued before either is
// interpolated.
template <int TY, int DG>
__device__ __forceinline__ void wcv_gather(const bf16* nb, bf16* buf,
                                           const int* corner,
                                           const uint32_t* wax,
                                           const uint32_t* way, int c0,
                                           int W, int C, int vec) {
  using Cfg = CmCfg<TY, DG>;
  constexpr int N = Cfg::WIN * 4;
  const size_t row = (size_t)W * C;
  for (int i0 = threadIdx.x; i0 < N; i0 += 2 * Cfg::NT) {
    uint4 q[2][4];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h * Cfg::NT;
      const int c = c0 + (i & 3) * 8;
      const int base = i < N ? corner[i >> 2] : -1;
      live[h] = base >= 0 && c < C;
      if (live[h]) wcv_load(nb + (size_t)base * C + c, row, c, C, vec, q[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h * Cfg::NT;
      if (i >= N) break;
      const int pix = i >> 2;
      const uint4 v = live[h] ? wcv_lerp8(q[h], wax[pix], way[pix])
                              : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(buf + pix * CM_PS + (i & 3) * 8) = v;
    }
  }
}

// (2, 9) tiles serve grids of fewer blocks than SMs: one block an SM
// leaves their 576 threads the registers of the gather.
template <int TY, int DG>
__global__ void __launch_bounds__(CmCfg<TY, DG>::NT, TY == 2 ? 1 : 2)
warp_cv_mma_kernel(const bf16* __restrict__ prv,
                   const bf16* __restrict__ nxt,
                   const float* __restrict__ flow, bf16* __restrict__ out,
                   int H, int W, int C, float ww, int vec) {
  using Cfg = CmCfg<TY, DG>;
  extern __shared__ __align__(16) unsigned char wcv_smem[];
  bf16* const buf = reinterpret_cast<bf16*>(wcv_smem);
  int* const corner = reinterpret_cast<int*>(buf + Cfg::STAGE);
  uint32_t* const wax = reinterpret_cast<uint32_t*>(corner + Cfg::WIN);
  uint32_t* const way = wax + Cfg::WIN;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * CM_TX, y0 = blockIdx.y * TY;
  const int warp = threadIdx.x >> 5;
  const size_t plane = (size_t)H * W;
  const bf16* const pb = prv + (size_t)b * plane * C;
  const bf16* const nb = nxt + (size_t)b * plane * C;
  const int n_chunks = (C + CM_CC - 1) / CM_CC;
  const int ty = warp % TY, di0 = warp / TY * Cfg::DI;

  // the warped window of chunk ch, then a barrier
  auto window = [&](int ch) {
    wcv_gather<TY, DG>(nb, buf, corner, wax, way, ch * CM_CC, W, C, vec);
    cp_async_wait_all();
    __syncthreads();
  };
  // chunk 0's prv tile by cp.async, in flight during the corners and the
  // gather
  cm_stage<TY, DG>(nb, pb, buf, 0, Cfg::WIN, Cfg::PIX, x0, y0, H, W, C,
                   vec, 0);
  cp_async_commit();
  wcv_corners<TY, DG>(flow + (size_t)b * plane * 2, corner, wax, way, x0,
                      y0, H, W, ww);
  __syncthreads();
  // Chunk 0 (the only one at C <= 32) is gathered before the sums are
  // live, so that its loads in flight do not compete with them for
  // registers.
  window(0);
  float acc[Cfg::DI][2][4];
#pragma unroll
  for (int d = 0; d < Cfg::DI; ++d)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[d][j][r] = 0.0f;
  cm_products<TY, DG>(acc, buf, 0, C, ty, di0);
  for (int ch = 1; ch < n_chunks; ++ch) {
    __syncthreads();
    cm_stage<TY, DG>(nb, pb, buf, ch * CM_CC, Cfg::WIN, Cfg::PIX, x0, y0, H,
                     W, C, vec, 0);
    cp_async_commit();
    window(ch);
    cm_products<TY, DG>(acc, buf, ch, C, ty, di0);
  }
  __syncthreads();
  cm_epilogue<TY, DG>(acc, buf, out, b, H, W, C, x0, y0, ty, di0);
}

template <int TY, int DG>
cudaError_t launch_wcv_mma(const void* prv, const void* nxt,
                           const void* flow, void* out, int B, int H, int W,
                           int C, float ww, cudaStream_t stream) {
  using Cfg = CmCfg<TY, DG>;
  const int ny = (H + TY - 1) / TY;
  if (ny > 65535 || B > 65535) return cudaErrorInvalidValue;
  // one stage, then the corner origins and both weights
  const size_t smem = Cfg::STAGE * sizeof(bf16) + 3 * Cfg::WIN * 4;
  static_assert(Cfg::STAGE * sizeof(bf16) + 3 * Cfg::WIN * 4 <= 48 * 1024,
                "no opt-in to more dynamic shared memory is made");
  const int vec = C % 8 == 0 && ((reinterpret_cast<uintptr_t>(prv) |
                                  reinterpret_cast<uintptr_t>(nxt)) %
                                 16) == 0;
  warp_cv_mma_kernel<TY, DG>
      <<<dim3((W + CM_TX - 1) / CM_TX, ny, B), Cfg::NT, smem, stream>>>(
          static_cast<const bf16*>(prv), static_cast<const bf16*>(nxt),
          static_cast<const float*>(flow), static_cast<bf16*>(out), H, W, C,
          ww, vec);
  return cudaGetLastError();
}

cudaError_t launch_wcv_bf16(const void* prv, const void* nxt,
                            const void* flow, void* out, int B, int H, int W,
                            int C, float ww, cudaStream_t stream) {
  cudaError_t err;
  switch (cm_tile_rows(B, H, W, &err)) {
    case 8:
      return launch_wcv_mma<8, 1>(prv, nxt, flow, out, B, H, W, C, ww,
                                  stream);
    case 4:
      return launch_wcv_mma<4, 3>(prv, nxt, flow, out, B, H, W, C, ww,
                                  stream);
    case 2:
      return launch_wcv_mma<2, 9>(prv, nxt, flow, out, B, H, W, C, ww,
                                  stream);
    default: return err;
  }
}

}  // namespace qpw

extern "C" int qpw_warp_cost_volume(const void* prv, const void* nxt,
                                    const void* flow, void* out, int B, int H,
                                    int W, int C, float ww, int dtype,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 2 || W < 2 || C < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return qpw::launch_correlate<float, true>(prv, nxt, flow, out, B, H, W,
                                              C, ww, 0, s);
  if (dtype == 1)
    return qpw::launch_wcv_bf16(prv, nxt, flow, out, B, H, W, C, ww, s);
  return cudaErrorInvalidValue;
}
