// The 81-offset correlation on the CUDA cores: the float32 bodies of K1
// (cost_volume.cu) and of the fused warp+correlate K3 (warp_cv.cu). Both
// bf16 bodies run on the tensor cores instead (cv_mma.cuh:
// cost_volume_mma_kernel, warp_cv_mma_kernel).
//
//   out[b,y,x,k] = leaky_relu_0.1((1/C) * sum_c prv[b,y,x,c] * src[b,y+di,x+dj,c])
//   di, dj in [-4, 4], k = (di+4)*9 + (dj+4), src zero outside the image,
//
// with src = nxt (K1) or src = backward_warp(nxt, clamp(flow, +-ww)) (K3).
// All tensors are NHWC and contiguous; sums are float32.
//
// One block owns a TY x TX tile of output pixels, one thread per pixel,
// each with its 81 float accumulators in registers. Per chunk of CC
// channels the block stages the prv tile and the (TY+8) x (TX+8) haloed
// src window in shared memory, channel-major so that a warp (one tile row)
// reads consecutive addresses. Under WARP the window is produced by a
// 4-corner bilinear gather from nxt instead of a copy; the corner origin
// and weights of each window position are computed once per block.
//
// What bounds it on the H100: not device memory (a level's maps are read
// about once, the halo's re-reads hit L2) but the shared-memory operand
// loads, one per FMA (81 loads for a pixel's 81 FMAs a channel), and the
// staging: scalar 4-byte loads, a chunk of 8 channels between two
// barriers, no copy in flight during the FMAs, and each thread storing its
// own 81 outputs 81 elements from its neighbour's. float32 stays here
// because its products must be float32 (TF32 is not within 1e-5 of the
// plain version). The template keeps the element type T: rnd<T> is the
// identity for float.
#pragma once

#include "common.cuh"

namespace qpw {

constexpr int CV_R = 4;
constexpr int CV_D = 2 * CV_R + 1;  // 9
constexpr int CV_K = CV_D * CV_D;   // 81
constexpr int CV_TX = 32;           // tile width: one warp per tile row
constexpr int CV_TY = 8;            // tile rows: 256 threads
constexpr int CV_CC = 8;            // channels per shared-memory chunk
constexpr int CV_WX = CV_TX + 2 * CV_R;  // 40: haloed window width
constexpr int CV_WY = CV_TY + 2 * CV_R;  // 16: haloed window rows
constexpr int CV_WXP = CV_WX + 1;        // row stride, padded against conflicts
constexpr int CV_THREADS = CV_TX * CV_TY;

template <typename T, bool WARP>
__global__ void __launch_bounds__(CV_THREADS)
correlate_kernel(const T* __restrict__ prv, const T* __restrict__ nxt,
                 const float* __restrict__ flow, T* __restrict__ out,
                 int H, int W, int C, float ww) {
  __shared__ float win[CV_CC][CV_WY][CV_WXP];
  __shared__ float pv[CV_CC][CV_TY][CV_TX];
  // WARP only: per window position, the clamped corner origin y0*W+x0
  // (-1 outside the image, where the window is zero) and the weights.
  __shared__ int corner[WARP ? CV_WY * CV_WX : 1];
  __shared__ float wax[WARP ? CV_WY * CV_WX : 1];
  __shared__ float way[WARP ? CV_WY * CV_WX : 1];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * CV_TX;
  const int y0 = blockIdx.y * CV_TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * CV_TX + tx;
  const size_t plane = (size_t)H * W;
  const T* nb = nxt + (size_t)b * plane * C;
  const T* pb = prv + (size_t)b * plane * C;

  if (WARP) {
    // ops/warp.py:warp_coords on the flow clamped to +-ww.
    for (int p = tid; p < CV_WY * CV_WX; p += CV_THREADS) {
      const int gy = y0 - CV_R + p / CV_WX;
      const int gx = x0 - CV_R + p % CV_WX;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
        corner[p] = -1;
        continue;
      }
      const float* f = flow + (((size_t)b * H + gy) * W + gx) * 2;
      const float qx = (float)gx + fminf(fmaxf(f[0], -ww), ww);
      const float qy = (float)gy + fminf(fmaxf(f[1], -ww), ww);
      const float fx0 = fminf(fmaxf(floorf(qx), 0.0f), (float)(W - 2));
      const float fy0 = fminf(fmaxf(floorf(qy), 0.0f), (float)(H - 2));
      corner[p] = (int)fy0 * W + (int)fx0;
      wax[p] = fminf(fmaxf(qx - fx0, 0.0f), 1.0f);
      way[p] = fminf(fmaxf(qy - fy0, 0.0f), 1.0f);
    }
    __syncthreads();
  }

  float acc[CV_K];
#pragma unroll
  for (int k = 0; k < CV_K; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CV_CC) {
    // Stage the src window, channel fastest across threads.
    for (int i = tid; i < CV_WY * CV_WX * CV_CC; i += CV_THREADS) {
      const int cc = i % CV_CC;
      const int p = i / CV_CC;
      const int wy = p / CV_WX, wx = p % CV_WX;
      const int c = c0 + cc;
      float v = 0.0f;
      if (c < C) {
        if (WARP) {
          const int base = corner[p];
          if (base >= 0) {
            // The interpolation of ops/warp.py:backward_warp, rounded to
            // T after every operation as eager PyTorch does.
            const float g00 = to_f<T>(nb[(size_t)base * C + c]);
            const float g01 = to_f<T>(nb[(size_t)(base + 1) * C + c]);
            const float g10 = to_f<T>(nb[(size_t)(base + W) * C + c]);
            const float g11 = to_f<T>(nb[(size_t)(base + W + 1) * C + c]);
            const float ax = rnd<T>(wax[p]), ay = rnd<T>(way[p]);
            const float top = rnd<T>(g00 + rnd<T>(rnd<T>(g01 - g00) * ax));
            const float bot = rnd<T>(g10 + rnd<T>(rnd<T>(g11 - g10) * ax));
            v = rnd<T>(top + rnd<T>(rnd<T>(bot - top) * ay));
          }
        } else {
          const int gy = y0 - CV_R + wy, gx = x0 - CV_R + wx;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            v = to_f<T>(nb[((size_t)gy * W + gx) * C + c]);
        }
      }
      win[cc][wy][wx] = v;
    }
    for (int i = tid; i < CV_TY * CV_TX * CV_CC; i += CV_THREADS) {
      const int cc = i % CV_CC;
      const int p = i / CV_CC;
      const int py = p / CV_TX, px = p % CV_TX;
      const int gy = y0 + py, gx = x0 + px, c = c0 + cc;
      pv[cc][py][px] = (c < C && gy < H && gx < W)
                           ? to_f<T>(pb[((size_t)gy * W + gx) * C + c])
                           : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < CV_CC; ++cc) {
      const float p = pv[cc][ty][tx];
#pragma unroll
      for (int di = 0; di < CV_D; ++di) {
#pragma unroll
        for (int dj = 0; dj < CV_D; ++dj) {
          acc[di * CV_D + dj] = fmaf(p, win[cc][ty + di][tx + dj],
                                     acc[di * CV_D + dj]);
        }
      }
    }
    __syncthreads();
  }

  const int x = x0 + tx, y = y0 + ty;
  if (x < W && y < H) {
    const float inv_c = 1.0f / (float)C;
    T* o = out + (((size_t)b * H + y) * W + x) * CV_K;
#pragma unroll
    for (int k = 0; k < CV_K; ++k) {
      const float a = acc[k] * inv_c;
      o[k] = from_f<T>(a > 0.0f ? a : a * 0.1f);
    }
  }
}

template <typename T, bool WARP>
cudaError_t launch_correlate(const void* prv, const void* nxt,
                             const void* flow, void* out, int B, int H,
                             int W, int C, float ww, cudaStream_t stream) {
  const dim3 grid((W + CV_TX - 1) / CV_TX, (H + CV_TY - 1) / CV_TY, B);
  const dim3 block(CV_TX, CV_TY);
  correlate_kernel<T, WARP><<<grid, block, 0, stream>>>(
      static_cast<const T*>(prv), static_cast<const T*>(nxt),
      static_cast<const float*>(flow), static_cast<T*>(out), H, W, C, ww);
  return cudaGetLastError();
}

}  // namespace qpw
