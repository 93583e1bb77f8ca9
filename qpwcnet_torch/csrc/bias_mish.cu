// The conv epilogue "bias add, then Mish" of every Mish conv that runs in
// PyTorch on the card (quantize/qlayers.py:QuantConv with act=mish, and
// the plain compositions that K2's and K5's backwards recompute), as one
// forward kernel and one backward kernel with a small bias-gradient pass.
// Replaces no TPU kernel: XLA fuses the JAX package's bias add and Mish
// into the conv's epilogue; eager PyTorch runs them as ~14 launches
// forward and ~22 backward, most of them reading and writing float32.
//
// Layout: a logical NCHW tensor in channels_last memory, so the channel is
// the innermost index: element i of the flat buffer has channel i % C.
//
// Forward (bias_mish_fwd): y = rnd_T(x + rnd_T(b)), out = mish<T>(y)
// (common.cuh): the rounding points of ops/activations.py:mish after the
// bias add in T, so the output equals the composition's bit for bit.
//
// Backward (bias_mish_bwd): from the saved pre-bias x, the bias and the
// incoming g it recomputes y and writes
//   dx = rnd_T(g * (f(y) + y * f'(y))),  f = tanh(softplus(y)),
//   f'(y) = 4 t (t + 1) / (t^2 + 2t + 2)^2,  t = e^y,
// in one float32 expression, with dx = g above 20, where the
// composition's factor is the constant 1. With a bias it also writes each
// block's float32 sums of that value per channel (before the rounding to
// T); bias_mish_dbias adds a channel's block sums in a fixed order into
// the float32 dbias. The blocks' rows depend on the shape alone, so dbias
// repeats bit for bit; no atomics.
//
// What bounds it on the H100: bytes. 4 bytes an element in bf16 forward
// (x in, out out), 6 backward (x, g in, dx out), against ~30 float
// instructions an element: one 16-byte load or store a thread per tensor.
// A channel count or an address that does not allow 16-byte vectors takes
// the same code one element at a time.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace qpw {

constexpr int kThreads = 256;
// the backward's blocks: at most this many (the wrapper's scratch holds
// kMaxBwdBlocks x C block sums), each a run of at least kMinBwdRows rows
constexpr int kMaxBwdBlocks = 1024;
constexpr int64_t kMinBwdRows = 128;
constexpr int kMaxFwdBlocks = 4096;

template <typename T, int VEC> struct Vec;
template <> struct Vec<bf16, 8> { using type = uint4; };
template <> struct Vec<float, 4> { using type = float4; };
template <typename T> struct Vec<T, 1> { using type = T; };

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  typename Vec<T, VEC>::type raw =
      *reinterpret_cast<const typename Vec<T, VEC>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f<T>(e[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  typename Vec<T, VEC>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) e[k] = from_f<T>(v[k]);
  *reinterpret_cast<typename Vec<T, VEC>::type*>(p) = raw;
}

// the bias of channels c .. c + VEC - 1 rounded to T (0 without a bias)
template <typename T, int VEC>
__device__ __forceinline__ void bias_of(const float* bias, int c,
                                        float (&b)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) b[k] = bias ? rnd<T>(bias[c + k]) : 0.0f;
}

// Each thread takes two vectors an iteration, a block-row apart, loads
// both before computing either (two 16-byte loads in flight), and keeps
// their channels' rounded biases in registers: at C dividing the
// block-row (every width of the models) a thread's channels never change.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bias_mish_fwd(const T* __restrict__ x, const float* __restrict__ bias,
                  T* __restrict__ out, int64_t n, int C) {
  const int64_t row = int64_t(blockDim.x) * VEC;
  const int64_t stride = int64_t(gridDim.x) * row * 2;
  int64_t i = int64_t(blockIdx.x) * row * 2 + int64_t(threadIdx.x) * VEC;
  const int step = int(stride % C), hop = int(row % C);
  int c0 = int(i % C), c1 = c0 + hop < C ? c0 + hop : c0 + hop - C;
  float b0[VEC], b1[VEC];
  bias_of<T, VEC>(bias, c0, b0);
  bias_of<T, VEC>(bias, c1, b1);
  for (; i < n; i += stride) {
    const bool two = i + row < n;
    float v0[VEC], v1[VEC];
    load<T, VEC>(x + i, v0);
    if (two) load<T, VEC>(x + i + row, v1);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v0[k] = mish<T>(rnd<T>(v0[k] + b0[k]));
    store<T, VEC>(out + i, v0);
    if (two) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v1[k] = mish<T>(rnd<T>(v1[k] + b1[k]));
      store<T, VEC>(out + i + row, v1);
    }
    if (step) {
      c0 = c0 + step < C ? c0 + step : c0 + step - C;
      c1 = c1 + step < C ? c1 + step : c1 + step - C;
      bias_of<T, VEC>(bias, c0, b0);
      bias_of<T, VEC>(bias, c1, b1);
    }
  }
}

// d/dy of y * tanh(softplus(y)) times g, in float; g above 20
__device__ __forceinline__ float mish_grad(float y, float g) {
  if (y > 20.0f) return g;
  const float t = expf(y);
  const float tt = t * t + 2.0f * t;
  const float d = tt + 2.0f;
  const float f = tt / d;
  const float fp = (4.0f * t * (t + 1.0f)) / (d * d);
  return g * (f + y * fp);
}

// Block b owns rows [b * rows_per_block, (b + 1) * rows_per_block) of the
// (rows, C) buffer; its threads are `lanes` rows x C / VEC vector columns.
template <typename T, int VEC>
__global__ void __launch_bounds__(1024)
    bias_mish_bwd(const T* __restrict__ x, const float* __restrict__ bias,
                  const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ partial, int64_t rows, int C,
                  int64_t rows_per_block) {
  extern __shared__ float sums[];  // [lanes][C]
  const int cols = C / VEC;
  const int col = threadIdx.x % cols, lane = threadIdx.x / cols;
  const int lanes = blockDim.x / cols;
  const int c = col * VEC;
  const int64_t r0 = int64_t(blockIdx.x) * rows_per_block;
  const int64_t r1 =
      rows < r0 + rows_per_block ? rows : r0 + rows_per_block;
  float b[VEC], acc[VEC];
  bias_of<T, VEC>(bias, c, b);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  for (int64_t r = r0 + lane; r < r1; r += lanes) {
    const int64_t i = r * C + c;
    float xv[VEC], gv[VEC];
    load<T, VEC>(x + i, xv);
    load<T, VEC>(g + i, gv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      xv[k] = mish_grad(rnd<T>(xv[k] + b[k]), gv[k]);
      acc[k] += xv[k];
    }
    store<T, VEC>(dx + i, xv);
  }
  if (partial == nullptr) return;
#pragma unroll
  for (int k = 0; k < VEC; ++k) sums[lane * C + c + k] = acc[k];
  __syncthreads();
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    float s = 0.0f;
    for (int l = 0; l < lanes; ++l) s += sums[l * C + ch];
    partial[int64_t(blockIdx.x) * C + ch] = s;
  }
}

// dbias[c] = the sum over the backward's blocks of partial[block][c]:
// 8 strided runs of blocks a channel, then the 8 runs, each in order.
__global__ void __launch_bounds__(256)
    bias_mish_dbias(const float* __restrict__ partial, float* __restrict__ dbias,
                    int blocks, int C) {
  __shared__ float runs[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < C)
    for (int k = threadIdx.y; k < blocks; k += 8) s += partial[int64_t(k) * C + c];
  runs[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.0f;
    for (int k = 0; k < 8; ++k) t += runs[k][threadIdx.x];
    dbias[c] = t;
  }
}

template <typename T>
int vec_of(const void* a, const void* b, const void* c, int C) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = !((reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c)) & 15);
  return aligned && C % V == 0 ? V : 1;
}

template <typename T, int VEC>
int launch_fwd(const void* x, const float* bias, void* out, int64_t n, int C,
               cudaStream_t s) {
  const int64_t rows = (n + int64_t(kThreads) * VEC - 1) / (kThreads * VEC);
  const int blocks = int(std::min<int64_t>((rows + 1) / 2, kMaxFwdBlocks));
  bias_mish_fwd<T, VEC><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), bias, static_cast<T*>(out), n, C);
  return cudaGetLastError();
}

// The backward's block shape, and its row split, which depends on the
// shape alone (so the sums' order does).
struct BwdPlan {
  int threads, lanes, blocks;
  int64_t rows_per_block;
};

inline BwdPlan bwd_plan(int64_t rows, int C, int vec) {
  BwdPlan p;
  const int cols = C / vec;
  p.lanes = cols >= kThreads ? 1 : kThreads / cols;
  p.threads = p.lanes * cols;
  p.rows_per_block = std::max<int64_t>(
      (rows + kMaxBwdBlocks - 1) / kMaxBwdBlocks, kMinBwdRows);
  p.blocks = int((rows + p.rows_per_block - 1) / p.rows_per_block);
  return p;
}

template <typename T, int VEC>
int launch_bwd(const void* x, const float* bias, const void* g, void* dx,
               float* partial, float* dbias, int64_t rows, int C,
               cudaStream_t s) {
  const BwdPlan p = bwd_plan(rows, C, VEC);
  if (p.threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = dbias ? size_t(p.lanes) * C * sizeof(float) : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  bias_mish_bwd<T, VEC><<<p.blocks, p.threads, smem, s>>>(
      static_cast<const T*>(x), bias, static_cast<const T*>(g),
      static_cast<T*>(dx), dbias ? partial : nullptr, rows, C,
      p.rows_per_block);
  if (dbias)
    bias_mish_dbias<<<(C + 31) / 32, dim3(32, 8), 0, s>>>(partial, dbias,
                                                          p.blocks, C);
  return cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const float* bias, void* out, int64_t n, int C,
        cudaStream_t s) {
  if (vec_of<T>(x, out, out, C) > 1)
    return launch_fwd<T, 16 / sizeof(T)>(x, bias, out, n, C, s);
  return launch_fwd<T, 1>(x, bias, out, n, C, s);
}

template <typename T>
int bwd(const void* x, const float* bias, const void* g, void* dx,
        float* partial, float* dbias, int64_t rows, int C, cudaStream_t s) {
  if (vec_of<T>(x, g, dx, C) > 1)
    return launch_bwd<T, 16 / sizeof(T)>(x, bias, g, dx, partial, dbias,
                                         rows, C, s);
  return launch_bwd<T, 1>(x, bias, g, dx, partial, dbias, rows, C, s);
}

}  // namespace qpw

// x, out: n elements in dtype (0 float32, 1 bfloat16), channel i % C;
// bias: C float32 values, or null.
extern "C" int qpw_bias_mish(const void* x, const void* bias, void* out,
                             long long n, int C, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || C < 1 || n % C) return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return qpw::fwd<float>(x, b, out, n, C, s);
  if (dtype == 1) return qpw::fwd<qpw::bf16>(x, b, out, n, C, s);
  return cudaErrorInvalidValue;
}

// x, g, dx: rows x C elements in dtype; bias: C float32 values or null;
// dbias: C float32 values, or null for no bias gradient; partial: the
// block sums' scratch, 1024 x C float32 values (null without dbias).
extern "C" int qpw_bias_mish_bwd(const void* x, const void* bias,
                                 const void* g, void* dx, void* partial,
                                 void* dbias, long long rows, int C,
                                 int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || C < 1 || (dbias && !partial)) return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  float* p = static_cast<float*>(partial);
  float* db = static_cast<float*>(dbias);
  if (dtype == 0) return qpw::bwd<float>(x, b, g, dx, p, db, rows, C, s);
  if (dtype == 1) return qpw::bwd<qpw::bf16>(x, b, g, dx, p, db, rows, C, s);
  return cudaErrorInvalidValue;
}
