// K4a / K4b: the cost-volume backward, from the pre-activation gradient
// dacc (B,H,W,81) = g * (out > 0 ? 1 : 0.1):
//
//   K4a  dprv[b,y,x,c] = (1/C) sum_k dacc[b,y,x,k]       * nxt[b,y+di,x+dj,c]
//   K4b  dnxt[b,u,v,c] = (1/C) sum_k dacc[b,u-di,v-dj,k] * prv[b,u-di,v-dj,c]
//
// di, dj in [-4, 4], k = (di+4)*9 + (dj+4); maps are zero outside the
// image, so K4b counts source pixels inside the image only.
// Replaces qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:_cv_bwd_prv_kernel
// and _cv_bwd_nxt_kernel.
//
// Both are gathers with the 81 coefficients of an output pixel fixed:
// K4a's are dacc at the pixel itself, K4b's are dacc[k] at the 81 source
// pixels (u-di, v-dj), one channel from each: the reversed-displacement
// correlation, written as a gather so that every sum has one fixed order
// and no atomics. One thread owns one output pixel, loads its 81
// coefficients into registers once, and per chunk of CV_CC channels reads
// the haloed (TY+8) x (TX+8) window of the C-channel map (nxt for K4a,
// prv for K4b) from shared memory, as K1 does (correlate.cuh). grid.z
// splits the channels into groups of CVB_CG, so that the coarse levels
// (8x16 pixels, C = 256) still launch some hundred blocks.
//
// Products are float32 and exact for bf16 inputs (two 8-bit mantissas);
// the TPU kernel rounds each product to the input dtype first. Sums are
// float32 (fmaf, in k order), the result is scaled by 1/C and rounded to
// the input dtype once.
#include "correlate.cuh"

namespace qpw {

constexpr int CVB_CG = 32;  // channels per block

template <typename T, bool REVERSED>
__global__ void __launch_bounds__(CV_THREADS)
cv_bwd_kernel(const T* __restrict__ dacc, const T* __restrict__ src,
              T* __restrict__ out, int H, int W, int C, int n_groups) {
  __shared__ float win[CV_CC][CV_WY][CV_WXP];

  const int b = blockIdx.z / n_groups;
  const int c_begin = (blockIdx.z % n_groups) * CVB_CG;
  const int c_end = min(C, c_begin + CVB_CG);
  const int x0 = blockIdx.x * CV_TX;
  const int y0 = blockIdx.y * CV_TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * CV_TX + tx;
  const int x = x0 + tx, y = y0 + ty;
  const bool live = x < W && y < H;
  const size_t plane = (size_t)H * W;
  const T* db = dacc + (size_t)b * plane * CV_K;
  const T* sb = src + (size_t)b * plane * C;

  float coef[CV_K];
#pragma unroll
  for (int i = 0; i < CV_D; ++i) {
#pragma unroll
    for (int j = 0; j < CV_D; ++j) {
      // K4b: the source pixel (y - di, x - dj) of displacement (di, dj)
      const int sy = REVERSED ? y - (i - CV_R) : y;
      const int sx = REVERSED ? x - (j - CV_R) : x;
      const int k = i * CV_D + j;
      coef[k] = (live && sy >= 0 && sy < H && sx >= 0 && sx < W)
                    ? to_f<T>(db[((size_t)sy * W + sx) * CV_K + k])
                    : 0.0f;
    }
  }

  const float inv_c = 1.0f / (float)C;
  T* o = out + (((size_t)b * H + y) * W + x) * C;
  for (int c0 = c_begin; c0 < c_end; c0 += CV_CC) {
    // Stage the window, channel fastest across threads.
    for (int i = tid; i < CV_WY * CV_WX * CV_CC; i += CV_THREADS) {
      const int cc = i % CV_CC;
      const int p = i / CV_CC;
      const int wy = p / CV_WX, wx = p % CV_WX;
      const int gy = y0 - CV_R + wy, gx = x0 - CV_R + wx, c = c0 + cc;
      win[cc][wy][wx] = (c < c_end && gy >= 0 && gy < H && gx >= 0 && gx < W)
                            ? to_f<T>(sb[((size_t)gy * W + gx) * C + c])
                            : 0.0f;
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int cc = 0; cc < CV_CC; ++cc) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < CV_D; ++i) {
#pragma unroll
          for (int j = 0; j < CV_D; ++j) {
            // K4a reads nxt at (y + di, x + dj): window (ty + i, tx + j);
            // K4b reads prv at (y - di, x - dj): window (ty + 8 - i, ...).
            const int wy = REVERSED ? ty + 2 * CV_R - i : ty + i;
            const int wx = REVERSED ? tx + 2 * CV_R - j : tx + j;
            acc = fmaf(coef[i * CV_D + j], win[cc][wy][wx], acc);
          }
        }
        if (c0 + cc < c_end) o[c0 + cc] = from_f<T>(acc * inv_c);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool REVERSED>
cudaError_t launch_cv_bwd(const void* dacc, const void* src, void* out,
                          int B, int H, int W, int C, cudaStream_t stream) {
  const int n_groups = (C + CVB_CG - 1) / CVB_CG;
  const dim3 grid((W + CV_TX - 1) / CV_TX, (H + CV_TY - 1) / CV_TY,
                  B * n_groups);
  const dim3 block(CV_TX, CV_TY);
  cv_bwd_kernel<T, REVERSED><<<grid, block, 0, stream>>>(
      static_cast<const T*>(dacc), static_cast<const T*>(src),
      static_cast<T*>(out), H, W, C, n_groups);
  return cudaGetLastError();
}

template <bool REVERSED>
int dispatch_cv_bwd(const void* dacc, const void* src, void* out, int B,
                    int H, int W, int C, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cv_bwd<float, REVERSED>(dacc, src, out, B, H, W, C, s);
  if (dtype == 1)
    return launch_cv_bwd<bf16, REVERSED>(dacc, src, out, B, H, W, C, s);
  return cudaErrorInvalidValue;
}

}  // namespace qpw

// K4a: dprv from dacc and nxt.
extern "C" int qpw_cost_volume_bwd_prv(const void* dacc, const void* nxt,
                                       void* dprv, int B, int H, int W, int C,
                                       int dtype, void* stream) {
  return qpw::dispatch_cv_bwd<false>(dacc, nxt, dprv, B, H, W, C, dtype,
                                     stream);
}

// K4b: dnxt from dacc and prv.
extern "C" int qpw_cost_volume_bwd_nxt(const void* dacc, const void* prv,
                                       void* dnxt, int B, int H, int W, int C,
                                       int dtype, void* stream) {
  return qpw::dispatch_cv_bwd<true>(dacc, prv, dnxt, B, H, W, C, dtype,
                                    stream);
}
