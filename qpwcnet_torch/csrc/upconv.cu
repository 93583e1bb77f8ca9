// K5: one fused decoder UpConv stage: ConvTranspose 4x4/s2 'SAME' + bias
// + Mish, NHWC in (B, H, W, Ci) and out (B, 2H, 2W, CO).
// Replaces qpwcnet_tpu/ops/pallas/upconv_kernel.py:_upconv_kernel.
//
// The weight is the port's stored float32 transpose-conv weight Wt
// (Ci, CO, 4, 4), the spatial flip of the Flax HWIO kernel, read as it is
// stored; the bias is the float32 (CO,). F.conv_transpose2d(stride 2,
// padding 1) gives, for output phase (r, s) of input position (i, j):
//   y[2i+r, 2j+s] = sum_{a,b in {0,1}} sum_ci x[i+a-1+r, j+b-1+s, ci]
//                                          * Wt[ci, co, 3-2a-r, 3-2b-s],
// with x zero outside the image. Each phase reads 4 of the 3x3
// neighbourhood's taps: the kernel computes just those 4 (the TPU
// kernel's zero-padded 9-tap phase matrices do 2.25x the work) and writes
// each output pixel straight to (2i+r, 2j+s).
//
// The weights and the bias are rounded to the compute dtype T, the sum is
// taken in float, rounded to T, the bias added in T and Mish applied in T:
// the rounding points of the unfused composition
// (ops/cuda/upconv_kernel.py:upconv_stage_plain).
//
// One block owns UC_TH x UC_TW input positions and all four phases: one
// warp per phase, so the weights a warp reads are the same for all its
// lanes (shared-memory broadcasts). Lane (ty, tx) holds UC_P positions of
// row ty, columns tx + 8p, and all CO channels of each in registers.
// Input channels go through shared memory UC_CK at a time, with their
// 1-pixel halo and their 4x4xCO weights, both converted to float; the
// weights are rearranged to [ky*4+kx][ci][co] on the way in.
#include "common.cuh"

namespace qpw {

constexpr int UC_TH = 4;              // input rows of a block
constexpr int UC_TW = 32;             // input columns of a block
constexpr int UC_P = 4;               // columns a lane holds (stride 8)
constexpr int UC_CK = 16;             // input channels per shared chunk
constexpr int UC_THREADS = 128;       // 4 warps: one per output phase
constexpr int UC_SH = UC_TH + 2;      // halo rows
constexpr int UC_SW = 40;             // halo columns (34) padded: rows of a
                                      // warp's reads fall in distinct banks
constexpr int UC_AREA = UC_SH * UC_SW;

template <typename T, int CO>
__global__ void __launch_bounds__(UC_THREADS)
upconv_kernel(const T* __restrict__ x, const float* __restrict__ wt,
              const float* __restrict__ bias, T* __restrict__ out, int H,
              int W, int Ci) {
  // A tap's [ci][co] block, padded by 4 floats: the 16 taps of one
  // (ci, co), written by 16 neighbouring lanes, fall in 8 banks, not 1.
  constexpr int WK = UC_CK * CO + 4;
  __shared__ __align__(16) float xs[UC_CK * UC_AREA];     // [ci][y][x]
  __shared__ __align__(16) float ws[16 * WK];             // [ky*4+kx][ci][co]

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * UC_TH, j0 = blockIdx.x * UC_TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp >> 1, s = warp & 1;
  const int ty = lane / 8, tx = lane % 8;
  const T* xb = x + (size_t)b * H * W * Ci;

  float acc[UC_P][CO];
#pragma unroll
  for (int p = 0; p < UC_P; ++p)
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[p][co] = 0.0f;

  for (int c0 = 0; c0 < Ci; c0 += UC_CK) {
    const int ck = min(UC_CK, Ci - c0);
    __syncthreads();  // the previous chunk's reads are done
    // Input rows i0-1 .. i0+TH, columns j0-1 .. j0+TW; zero outside.
    for (int e = threadIdx.x; e < ck * UC_SH * (UC_TW + 2);
         e += UC_THREADS) {
      const int ci = e % ck, pix = e / ck;
      const int py = pix / (UC_TW + 2), px = pix % (UC_TW + 2);
      const int iy = i0 - 1 + py, ix = j0 - 1 + px;
      float v = 0.0f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = to_f<T>(xb[((size_t)iy * W + ix) * Ci + c0 + ci]);
      xs[ci * UC_AREA + py * UC_SW + px] = v;
    }
    // The chunk's weights Wt[c0 .. c0+ck][co][ky][kx] are contiguous.
    const float* wc = wt + (size_t)c0 * CO * 16;
    for (int e = threadIdx.x; e < ck * CO * 16; e += UC_THREADS) {
      const int k = e % 16, co = (e / 16) % CO, ci = e / (16 * CO);
      ws[k * WK + ci * CO + co] = rnd<T>(wc[e]);
    }
    __syncthreads();

    for (int ci = 0; ci < ck; ++ci) {
      const float* xc = xs + ci * UC_AREA;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int k = (3 - 2 * a - r) * 4 + (3 - 2 * bb - s);
          const float4* wk =
              reinterpret_cast<const float4*>(ws + k * WK + ci * CO);
          const float* xr = xc + (ty + a + r) * UC_SW + tx + bb + s;
          float xv[UC_P];
#pragma unroll
          for (int p = 0; p < UC_P; ++p) xv[p] = xr[8 * p];
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 w4 = wk[q];
#pragma unroll
            for (int p = 0; p < UC_P; ++p) {
              acc[p][4 * q + 0] = fmaf(xv[p], w4.x, acc[p][4 * q + 0]);
              acc[p][4 * q + 1] = fmaf(xv[p], w4.y, acc[p][4 * q + 1]);
              acc[p][4 * q + 2] = fmaf(xv[p], w4.z, acc[p][4 * q + 2]);
              acc[p][4 * q + 3] = fmaf(xv[p], w4.w, acc[p][4 * q + 3]);
            }
          }
        }
      }
    }
  }

  const int i = i0 + ty;
  if (i >= H) return;
  const int Ho = 2 * H, Wo = 2 * W;
#pragma unroll
  for (int p = 0; p < UC_P; ++p) {
    const int j = j0 + tx + 8 * p;
    if (j >= W) continue;
    T* o = out + (((size_t)b * Ho + 2 * i + r) * Wo + 2 * j + s) * CO;
#pragma unroll
    for (int co = 0; co < CO; ++co)
      o[co] = from_f<T>(
          mish<T>(rnd<T>(rnd<T>(acc[p][co]) + rnd<T>(bias[co]))));
  }
}

template <typename T, int CO>
cudaError_t launch_upconv(const void* x, const void* wt, const void* bias,
                          void* out, int B, int H, int W, int Ci,
                          cudaStream_t stream) {
  const dim3 grid((W + UC_TW - 1) / UC_TW, (H + UC_TH - 1) / UC_TH, B);
  upconv_kernel<T, CO><<<grid, UC_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<T*>(out), H, W, Ci);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_upconv_co(int Co, const void* x, const void* wt,
                             const void* bias, void* out, int B, int H, int W,
                             int Ci, cudaStream_t s) {
  if (Co == 16) return launch_upconv<T, 16>(x, wt, bias, out, B, H, W, Ci, s);
  if (Co == 32) return launch_upconv<T, 32>(x, wt, bias, out, B, H, W, Ci, s);
  return cudaErrorInvalidValue;
}

}  // namespace qpw

extern "C" int qpw_upconv_stage(const void* x, const void* wt,
                                const void* bias, void* out, int B, int H,
                                int W, int Ci, int Co, int dtype,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qpw::launch_upconv_co<float>(Co, x, wt, bias, out, B, H, W, Ci, s);
  if (dtype == 1)
    return qpw::launch_upconv_co<qpw::bf16>(Co, x, wt, bias, out, B, H, W, Ci,
                                            s);
  return cudaErrorInvalidValue;
}
