// K2: one fused DownConv stage of the encoder stem:
//   conv3x3/s2 SAME + bias + Mish -> conv3x3 + bias + Mish
//   -> conv3x3 + bias + Mish,
// NHWC in and out. Replaces qpwcnet_tpu/ops/pallas/stem_kernel.py:_stem_kernel.
//
// SAME for the stride-2 conv on an even input pads (0, 1): output (i, j)
// reads x[2i+dy, 2j+dx], dy, dx in 0..2, zero at row H / column W. Each
// conv sums in float, rounds to the compute dtype T, adds the bias in T
// and applies Mish in T — the rounding points of the unfused PyTorch
// composition (ops/cuda/stem_kernel.py:downconv_stage_plain).
//
// One block owns a TS x TS output tile. It computes conv_a over the tile
// plus a 2-pixel halo (A) and conv_aa over the tile plus a 1-pixel halo
// (B), both in shared memory, channel-major. Halo positions outside the
// image are stored as zero: that is the zero padding the next conv reads.
// One thread computes all CO output channels of one position, so every
// input value is read once per tap and the weights (in shared memory,
// [ci][ky][kx][co]) are broadcast reads.
#include "common.cuh"

namespace qpw {

constexpr int ST_TS = 16;             // output tile
constexpr int ST_SA = ST_TS + 4;      // conv_a region: 2-pixel halo
constexpr int ST_SB = ST_TS + 2;      // conv_aa region: 1-pixel halo
constexpr int ST_THREADS = 256;

template <typename T, int CO>
__device__ __forceinline__ void load_weights(T* wsm, const T* w, int n) {
  for (int i = threadIdx.x; i < n; i += ST_THREADS) wsm[i] = w[i];
}

// bias + Mish of one position's CO sums, rounded to T first.
template <typename T, int CO>
__device__ __forceinline__ void epilogue(float (&acc)[CO],
                                         const T* __restrict__ bias) {
#pragma unroll
  for (int co = 0; co < CO; ++co)
    acc[co] = mish<T>(rnd<T>(rnd<T>(acc[co]) + to_f<T>(bias[co])));
}

// 3x3 stride-1 conv of CO channels from a channel-major shared region of
// side `src_side` at offset (sy, sx) of the output position's window.
template <typename T, int CO>
__device__ __forceinline__ void conv33_smem(float (&acc)[CO], const T* src,
                                            int src_side, int sy, int sx,
                                            const T* wsm) {
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.0f;
  const int area = src_side * src_side;
  for (int ci = 0; ci < CO; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float v = to_f<T>(src[ci * area + (sy + ky) * src_side + sx + kx]);
        const T* wk = wsm + ((ci * 3 + ky) * 3 + kx) * CO;
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[co] = fmaf(v, to_f<T>(wk[co]), acc[co]);
      }
    }
  }
}

template <typename T, int CO>
__global__ void __launch_bounds__(ST_THREADS)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w1,
            const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, const T* __restrict__ w3,
            const T* __restrict__ b3, T* __restrict__ out, int H, int W,
            int Cin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);  // [CO][SA*SA]
  T* sb = sa + CO * ST_SA * ST_SA;          // [CO][SB*SB]
  T* wsm = sb + CO * ST_SB * ST_SB;         // [ci][ky][kx][co]

  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * ST_TS, ox0 = blockIdx.x * ST_TS;
  const T* xb = x + (size_t)b * H * W * Cin;
  float acc[CO];

  // conv_a (stride 2) over the 2-pixel-haloed region, input from memory.
  load_weights<T, CO>(wsm, w1, 9 * Cin * CO);
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
          const T* xp = xb + ((size_t)iy * W + ix) * Cin;
          for (int ci = 0; ci < Cin; ++ci) {
            const float v = to_f<T>(xp[ci]);
            const T* wk = wsm + ((ci * 3 + ky) * 3 + kx) * CO;
#pragma unroll
            for (int co = 0; co < CO; ++co)
              acc[co] = fmaf(v, to_f<T>(wk[co]), acc[co]);
          }
        }
      }
      epilogue<T, CO>(acc, b1);
    }
#pragma unroll
    for (int co = 0; co < CO; ++co)
      sa[co * ST_SA * ST_SA + p] = from_f<T>(inside ? acc[co] : 0.0f);
  }
  __syncthreads();

  // conv_aa over the 1-pixel-haloed region, from A.
  load_weights<T, CO>(wsm, w2, 9 * CO * CO);
  __syncthreads();
  for (int p = threadIdx.x; p < ST_SB * ST_SB; p += ST_THREADS) {
    const int py = p / ST_SB, px = p % ST_SB;
    const int oy = oy0 - 1 + py, ox = ox0 - 1 + px;
    const bool inside = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
    if (inside) {
      conv33_smem<T, CO>(acc, sa, ST_SA, py, px, wsm);
      epilogue<T, CO>(acc, b2);
    }
#pragma unroll
    for (int co = 0; co < CO; ++co)
      sb[co * ST_SB * ST_SB + p] = from_f<T>(inside ? acc[co] : 0.0f);
  }
  __syncthreads();

  // conv_b over the tile, from B, straight to memory.
  load_weights<T, CO>(wsm, w3, 9 * CO * CO);
  __syncthreads();
  for (int p = threadIdx.x; p < ST_TS * ST_TS; p += ST_THREADS) {
    const int py = p / ST_TS, px = p % ST_TS;
    const int oy = oy0 + py, ox = ox0 + px;
    if (oy >= Ho || ox >= Wo) continue;
    conv33_smem<T, CO>(acc, sb, ST_SB, py, px, wsm);
    epilogue<T, CO>(acc, b3);
    T* o = out + (((size_t)b * Ho + oy) * Wo + ox) * CO;
#pragma unroll
    for (int co = 0; co < CO; ++co) o[co] = from_f<T>(acc[co]);
  }
}

template <typename T, int CO>
cudaError_t launch_stem(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* w3,
                        const void* b3, void* out, int B, int H, int W,
                        int Cin, cudaStream_t stream) {
  const int wmax = 9 * (Cin > CO ? Cin : CO) * CO;
  const size_t smem =
      sizeof(T) * ((size_t)CO * (ST_SA * ST_SA + ST_SB * ST_SB) + wmax);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<T, CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int Ho = H / 2, Wo = W / 2;
  const dim3 grid((Wo + ST_TS - 1) / ST_TS, (Ho + ST_TS - 1) / ST_TS, B);
  using P = const T*;
  stem_kernel<T, CO><<<grid, ST_THREADS, smem, stream>>>(
      static_cast<P>(x), static_cast<P>(w1), static_cast<P>(b1),
      static_cast<P>(w2), static_cast<P>(b2), static_cast<P>(w3),
      static_cast<P>(b3), static_cast<T*>(out), H, W, Cin);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stem_co(int Cout, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           const void* w3, const void* b3, void* out, int B,
                           int H, int W, int Cin, cudaStream_t s) {
  if (Cout == 16)
    return launch_stem<T, 16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, Cin, s);
  if (Cout == 32)
    return launch_stem<T, 32>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, Cin, s);
  return cudaErrorInvalidValue;
}

}  // namespace qpw

extern "C" int qpw_downconv_stage(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* w3,
                                  const void* b3, void* out, int B, int H,
                                  int W, int Cin, int Cout, int dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qpw::launch_stem_co<float>(Cout, x, w1, b1, w2, b2, w3, b3, out, B,
                                      H, W, Cin, s);
  if (dtype == 1)
    return qpw::launch_stem_co<qpw::bf16>(Cout, x, w1, b1, w2, b2, w3, b3, out,
                                          B, H, W, Cin, s);
  return cudaErrorInvalidValue;
}
