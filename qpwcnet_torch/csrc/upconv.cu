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
// neighbourhood's taps: both bodies compute just those 4 (the TPU
// kernel's zero-padded 9-tap phase matrices do 2.25x the work) and write
// each output pixel once, at (2i+r, 2j+s).
//
// The weights and the bias are rounded to the compute dtype T, the sum is
// taken in float, rounded to T, the bias added in T and Mish applied in T:
// the rounding points of the unfused composition
// (ops/cuda/upconv_kernel.py:upconv_stage_plain).
//
// What bounds it on the H100: per input position 4 phases x 4 taps x Ci x
// CO multiply-adds against 2·Ci bytes in and 8·CO bytes out, 256
// operations a byte at Ci 128 -> CO 32 and 128 at 64 -> 16. On the bf16
// tensor cores (989 TFLOP/s) that is under the ridge point (~295), so the
// bytes bound it; on the CUDA cores (67 TFLOP/s) the FMAs would, ten
// times above that.
//
// bfloat16 body (upconv_mma_kernel): an implicit GEMM per output phase on
// the tensor cores, M = input positions, N = CO, K = 4 taps x Ci, bf16
// operands and float32 sums (mma.sync m16n8k16, operands by ldmatrix).
//  - Weights resident: each block keeps its phases' taps in shared memory
//    as [tap][co][ci] bf16 (ci contiguous: B's column-major fragment, no
//    .trans; 136 KB at 128 -> 32), rounded from the stored float32 weight
//    once. The grid is persistent (at most the resident blocks), and the
//    two blocks of a cluster stage the weight together through
//    distributed shared memory, so it crosses L2 once per block pair
//    (~70 times a call), not once per tile.
//  - A tile is TH x 16 input positions (TH = 4 at CO = 32, 8 at CO = 16)
//    with its 1-pixel halo, all Ci, in shared memory as [y][x][ci]; the
//    pixel stride Ci + 8 bf16 is an odd number of 16-byte units, so
//    ldmatrix's eight row reads fall in distinct banks. A's rows for tap
//    (a, b) of phase (r, s) are the tile's pixels shifted by (a + r,
//    b + s): every tap reads the same staged tile, no im2col. Tiles are
//    copied with cp.async (16-byte copies, zero-filled outside the image
//    and past Ci).
//  - 16 warps a block in two groups of 8, each group on its own tiles
//    with its own buffer; the groups' products take turns, and a group
//    starts copying its next tile as soon as its products are done, so
//    its epilogue and that copy run under the other group's products. In
//    a group, 2 warps a phase, each TH/2 input rows of 16 positions (m16
//    tiles) x CO in float32 accumulators (32 a lane). Where four-phase
//    tiles would not cover the SMs (batch 1), a block takes one output row
//    parity r (two phases, half the weights), so the grid has twice the
//    tiles.
//  - The epilogue rounds and applies Mish as above and stores each lane's
//    channel pairs straight from registers: a warp's store covers 8 output
//    pixels' 16-byte runs. (Staging the output tile in shared memory for
//    16-byte stores measured no faster, and its buffer would keep the next
//    tile's copy waiting until the stores are done.)
// What bounds it as built: mma.sync's rate at 128 -> 32 (the products of
// one tile take about as long as its epilogue), the per-element epilogue
// (Mish: an exp and a division per output value) at 64 -> 16, and the
// weight staging at the small shapes; PERF.md has the measured split.
// float32 body (upconv_kernel): CUDA-core FMAs, kept so that float32
// stays equal to the plain version within 1e-5 (TF32 would not): one
// warp per phase, each lane 4 positions x CO sums in registers, input and
// weights in 16-channel float chunks.
//
// Wide stages (CO 64 and 128 at Ci 256, decoder stages 0-1, both
// dtypes): the resident bf16 weights would be 0.5-1.1 MB, and one lane's
// CO sums of 4 positions no longer fit in registers, so these stages run
// the implicit GEMM of conv_gemm.cuh, the 4 taps a phase reads (K = 4 x
// Ci) streamed through shared memory, the tiles of all four phases in one
// persistent launch: prep_wt rounds the weight into the GEMM's per-phase
// layout in the wrapper's scratch, then one GEMM launch computes and
// writes every phase.
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"
#include "conv_gemm.cuh"
#include "mma.cuh"

namespace qpw {

// ---------------------------------------------------------------- float32

constexpr int UC_TH = 4;              // input rows of a block
constexpr int UC_TW = 32;             // input columns of a block
constexpr int UC_P = 4;               // columns a lane holds (stride 8)
constexpr int UC_CK = 16;             // input channels per shared chunk
constexpr int UC_THREADS = 128;       // 4 warps: one per output phase
constexpr int UC_SH = UC_TH + 2;      // halo rows
constexpr int UC_SW = 40;             // halo columns (34) padded: rows of a
                                      // warp's reads fall in distinct banks
constexpr int UC_AREA = UC_SH * UC_SW;

template <int CO>
__global__ void __launch_bounds__(UC_THREADS)
upconv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
              const float* __restrict__ bias, float* __restrict__ out,
              int H, int W, int Ci) {
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
  const float* xb = x + (size_t)b * H * W * Ci;

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
        v = xb[((size_t)iy * W + ix) * Ci + c0 + ci];
      xs[ci * UC_AREA + py * UC_SW + px] = v;
    }
    // The chunk's weights Wt[c0 .. c0+ck][co][ky][kx] are contiguous.
    const float* wc = wt + (size_t)c0 * CO * 16;
    for (int e = threadIdx.x; e < ck * CO * 16; e += UC_THREADS) {
      const int k = e % 16, co = (e / 16) % CO, ci = e / (16 * CO);
      ws[k * WK + ci * CO + co] = wc[e];
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
    float* o = out + (((size_t)b * Ho + 2 * i + r) * Wo + 2 * j + s) * CO;
#pragma unroll
    for (int co = 0; co < CO; ++co)
      o[co] = mish<float>(acc[p][co] + bias[co]);
  }
}

template <int CO>
cudaError_t launch_upconv_f32(const void* x, const void* wt,
                              const void* bias, void* out, int B, int H,
                              int W, int Ci, cudaStream_t stream) {
  const dim3 grid((W + UC_TW - 1) / UC_TW, (H + UC_TH - 1) / UC_TH, B);
  upconv_kernel<CO><<<grid, UC_THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(out), H, W, Ci);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16

constexpr int UM_TW = 16;                // input columns of a tile (one m16)
constexpr int UM_SW = UM_TW + 2;         // with the halo
constexpr int UM_GROUPS = 2;             // warp groups a block
constexpr int UM_GTHREADS = 256;         // 8 warps a group
constexpr int UM_THREADS = UM_GROUPS * UM_GTHREADS;
constexpr int UM_SMEM_MAX = 232448;      // 227 KB a block (sm_90)
constexpr int UM_CL = 2;                 // blocks a cluster at four phases

// Barrier of one warp group (named barrier 1 + grp; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(UM_GTHREADS)
               : "memory");
}

// The two groups' products take turns (named barriers 3 and 4): a group
// waits for its turn, and passes the turn to the other group once its
// products are done, so one group's epilogue, stores and next copy run
// under the other's products instead of beside them.
__device__ __forceinline__ void turn_wait(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 3), "n"(UM_THREADS)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int grp) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"((grp ^ 1) + 3), "n"(UM_THREADS)
               : "memory");
}

// Input rows of a tile: 8 at CO = 16, so that a warp's m16 tiles share
// each B fragment 4 times, as 4 rows share it at CO = 32.
__host__ __device__ constexpr int um_th(int co) { return co == 16 ? 8 : 4; }

// Shared memory of a block: the resident weights [NPH*4 taps][CO][Ci+8]
// and one buffer a warp group for its haloed input tile [TH+2][UM_SW][Ci+8].
__host__ __device__ constexpr int um_buf_el(int co, int cip) {
  return (um_th(co) + 2) * UM_SW * (cip + 8);
}
inline size_t um_smem_bytes(int co, int nph, int cip) {
  return 2 * ((size_t)nph * 4 * co * (cip + 8) +
              (size_t)UM_GROUPS * um_buf_el(co, cip));
}

// Tile t of the block's phase group: (batch, first input row, column).
__device__ __forceinline__ void um_tile(int t, int ng, int th, int tiles_w,
                                        int tiles_h, int& b, int& i0,
                                        int& j0) {
  int q = t / ng;
  j0 = (q % tiles_w) * UM_TW;
  q /= tiles_w;
  i0 = (q % tiles_h) * th;
  b = q / tiles_h;
}

// Stage input rows i0-1 .. i0+th, columns j0-1 .. j0+TW, channels
// 0 .. CiP-1 of image b into xs ([y][x][ci], pixel stride CiP + 8), zero
// outside the image and past Ci, by the tid-th of a group's threads.
// vec: cp.async 16-byte copies (Ci a multiple of 8, x 16-byte aligned);
// else synchronous element loads.
__device__ __forceinline__ void um_load_tile(bf16* xs,
                                             const bf16* __restrict__ x,
                                             int th, int b, int i0, int j0,
                                             int H, int W, int Ci, int CiP,
                                             bool vec, int tid) {
  const int ps = CiP + 8, nc = CiP / 8;
  for (int e = tid; e < (th + 2) * UM_SW * nc; e += UM_GTHREADS) {
    const int c = (e % nc) * 8, pix = e / nc;
    const int iy = i0 - 1 + pix / UM_SW, ix = j0 - 1 + pix % UM_SW;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    bf16* dst = xs + pix * ps + c;
    const bf16* src =
        in ? x + (((size_t)b * H + iy) * W + ix) * Ci + c : x;
    if (vec) {
      cp_async16(dst, src, in && c < Ci ? 16 : 0);
    } else {
      __align__(16) unsigned short v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = in && c + k < Ci ? __bfloat16_as_ushort(src[k]) : 0;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// NPH phases a block: 4 (all), or 2 (the row parity r = blockIdx.x % 2,
// both column parities). The block's two warp groups share the weights,
// walk their own tiles with their own buffers and take turns on the
// tensor cores. Tile strides are multiples of 4 / NPH, so a block's phase
// group stays the same over its tiles.
template <int CO, int NPH>
__global__ void __launch_bounds__(UM_THREADS, 1)
upconv_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ bias, bf16* __restrict__ out,
                  int H, int W, int Ci, int CiP, int tiles_w, int tiles_h,
                  int n_tiles, int vec) {
  constexpr int TH = um_th(CO);            // input rows of a tile
  constexpr int NG = 4 / NPH;              // phase groups
  constexpr int WPP = 8 / NPH;             // warps a phase
  constexpr int MT = TH / WPP;             // m16 tiles (input rows) a warp
  constexpr int NT = CO / 8;               // n8 tiles
  extern __shared__ __align__(16) unsigned char um_smem[];
  const int ps = CiP + 8;
  bf16* ws = reinterpret_cast<bf16*>(um_smem);  // [NPH*4][CO][ps]
  const int grp = threadIdx.x / UM_GTHREADS, gtid = threadIdx.x % UM_GTHREADS;
  bf16* buf = ws + NPH * 4 * CO * ps + grp * um_buf_el(CO, CiP);

  const int warp = gtid / 32, lane = threadIdx.x % 32;
  const int pg = blockIdx.x % NG;
  const int pl = warp / WPP, ty0 = (warp % WPP) * MT;
  const int r = NPH == 4 ? pl >> 1 : pg, s = NPH == 4 ? pl & 1 : pl;

  const int step = UM_GROUPS * gridDim.x;
  int t = blockIdx.x + grp * gridDim.x;
  int b = 0, i0 = 0, j0 = 0;
  if (t < n_tiles) {
    um_tile(t, NG, TH, tiles_w, tiles_h, b, i0, j0);
    um_load_tile(buf, x, TH, b, i0, j0, H, W, Ci, CiP, vec, gtid);
  }
  cp_async_commit();

  // Meanwhile the block's taps, rounded to bf16: slot (phase pl, a, b)
  // holds Wt[:, :, 3-2a-r, 3-2b-s] as [co][ci], zero past Ci. A thread
  // takes two channels of one co (each 16 taps contiguous in Wt), so a
  // warp's stores of a slot are consecutive words. The blocks of a
  // cluster (UM_CL at four phases a block, else 1) share the work: each
  // reads its share of Wt and writes it into every block's shared
  // memory, so the weight crosses L2 once a cluster, not once a block.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = cluster.num_blocks(), crank = cluster.block_rank();
  bf16* dst[UM_CL];
#pragma unroll
  for (int q = 0; q < UM_CL; ++q)
    dst[q] = q < cn ? cluster.map_shared_rank(ws, q) : ws;
  const int half = CiP / 2;
#pragma unroll 4
  for (int e = crank * UM_THREADS + threadIdx.x; e < half * CO;
       e += cn * UM_THREADS) {
    const int ci = 2 * (e % half), co = e / half;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
      const int ry = 3 - ky;  // 2a + r
      if (NPH == 2 && (ry & 1) != pg) continue;
      float w[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ci + h < Ci)
          v = __ldg(reinterpret_cast<const float4*>(
              wt + ((size_t)(ci + h) * CO + co) * 16 + ky * 4));
        w[h][0] = v.x, w[h][1] = v.y, w[h][2] = v.z, w[h][3] = v.w;
      }
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const int rx = 3 - kx;  // 2b + s
        const int slot = (NPH == 4 ? 2 * (ry & 1) + (rx & 1) : rx & 1) * 4 +
                         (ry >> 1) * 2 + (rx >> 1);
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(w[0][kx]);
        v.y = __float2bfloat16_rn(w[1][kx]);
#pragma unroll
        for (int q = 0; q < UM_CL; ++q)
          if (q < cn)
            *reinterpret_cast<__nv_bfloat162*>(
                dst[q] + (slot * CO + co) * ps + ci) = v;
      }
    }
  }
  float bz[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      bz[nt][k] = rnd<bf16>(bias[nt * 8 + 2 * (lane & 3) + k]);
  cluster.sync();  // the weights are in place, in every block of the cluster

  const int Ho = 2 * H, Wo = 2 * W;
  const int other = blockIdx.x + (grp ^ 1) * gridDim.x;  // its first tile
  for (int it = 0; t < n_tiles; t += step, ++it) {
    cp_async_wait_all();
    group_sync(grp);  // the group's tile is in place
    if (grp == 1 || it > 0) turn_wait(grp);

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.0f;

#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int a = tap >> 1, bb = tap & 1;
      // ldmatrix rows: A's lane l -> position l % 16 of its row, channels
      // +8 for l >= 16; B's lane l -> co (l / 16) * 8 + l % 8 of a 16-wide
      // pair, channels +8 for odd l / 8.
      uint32_t aa[MT], ba[NT / 2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        aa[mt] = smem_addr(buf + ((ty0 + mt + a + r) * UM_SW + (lane & 15) +
                                  bb + s) * ps + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ba[np] = smem_addr(ws + ((pl * 4 + tap) * CO + np * 16 +
                                 (lane >> 4) * 8 + (lane & 7)) * ps +
                           ((lane >> 3) & 1) * 8);
      for (int kk = 0; kk < CiP; kk += 16) {
        uint32_t af[MT][4], bf[NT / 2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], aa[mt] + 2 * kk);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          ldmatrix_x4(bf[np], ba[np] + 2 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], af[mt], bf[nt / 2][2 * (nt & 1)],
                     bf[nt / 2][2 * (nt & 1) + 1]);
      }
    }
    // Group 0's products it precede group 1's it, which precede 0's it + 1.
    if (other + (it + grp) * step < n_tiles) turn_pass(grp);
    group_sync(grp);  // the tile is read: the buffer takes the next one
    const int cb = b, ci0 = i0, cj0 = j0;
    if (t + step < n_tiles) {
      um_tile(t + step, NG, TH, tiles_w, tiles_h, b, i0, j0);
      um_load_tile(buf, x, TH, b, i0, j0, H, W, Ci, CiP, vec, gtid);
    }
    cp_async_commit();

    // Meanwhile: sum -> bf16, + bias, Mish, stored at (2i+r, 2j+s):
    // acc[..][k] is position (lane / 4) + 8 (k / 2) of its row, channels
    // nt*8 + 2 (lane % 4) + k % 2.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int i = ci0 + ty0 + mt;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = cj0 + (lane >> 2) + 8 * h;
        if (i >= H || j >= W) continue;
        bf16* o = out +
                  (((size_t)cb * Ho + 2 * i + r) * Wo + 2 * j + s) * CO +
                  2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          __nv_bfloat162 v;
          v.x = from_f<bf16>(mish<bf16>(
              rnd<bf16>(rnd<bf16>(acc[mt][nt][2 * h]) + bz[nt][0])));
          v.y = from_f<bf16>(mish<bf16>(
              rnd<bf16>(rnd<bf16>(acc[mt][nt][2 * h + 1]) + bz[nt][1])));
          *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) = v;
        }
      }
    }
  }
}

// Resident clusters of each instantiation, by device and Ci padded to 16
// (index cip / 16 <= 14): found once (the shared-memory opt-in and the
// occupancy query cost microseconds of host time a call) and kept, as
// clusters + 1 (0: not known yet).
namespace {
constexpr int UM_MAX_DEV = 16, UM_MAX_K = 16;
std::atomic<int> um_known[2][2][UM_MAX_DEV][UM_MAX_K];
}  // namespace

template <int CO, int NPH>
cudaError_t launch_upconv_mma(const void* x, const void* wt,
                              const void* bias, void* out, int B, int H,
                              int W, int Ci, int dev, cudaStream_t stream) {
  const int cip = (Ci + 15) / 16 * 16;
  const size_t smem = um_smem_bytes(CO, NPH, cip);
  if (smem > (size_t)UM_SMEM_MAX) return cudaErrorInvalidValue;
  constexpr int NG = 4 / NPH, TH = um_th(CO), CL = NPH == 4 ? UM_CL : 1;
  auto kern = upconv_mma_kernel<CO, NPH>;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(UM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;

  const int k = cip / 16;
  std::atomic<int>* known = dev < UM_MAX_DEV && k < UM_MAX_K
                                ? &um_known[CO == 32][NPH == 4][dev][k]
                                : nullptr;
  int n_cl = known ? known->load(std::memory_order_relaxed) - 1 : -1;
  if (n_cl < 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, UM_SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n_cl, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (known) known->store(n_cl + 1, std::memory_order_relaxed);
  }
  if (n_cl < 1) return cudaErrorInvalidConfiguration;

  const int tiles_w = (W + UM_TW - 1) / UM_TW;
  const int tiles_h = (H + TH - 1) / TH;
  const long long n_tiles = (long long)B * tiles_h * tiles_w * NG;
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const long long resident = (long long)n_cl * CL;
  long long grid = n_tiles < resident ? n_tiles : resident;
  constexpr int M = NG * CL;  // phase groups stay put; whole clusters
  grid = grid < M ? M : grid - grid % M;
  cfg.gridDim = dim3((unsigned)grid);
  const bool vec = Ci % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, Ci,
      cip, tiles_w, tiles_h, (int)n_tiles, vec ? 1 : 0);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// All four phases a block where those tiles cover the SMs, else two.
template <int CO>
cudaError_t launch_upconv_bf16(const void* x, const void* wt,
                               const void* bias, void* out, int B, int H,
                               int W, int Ci, cudaStream_t stream) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((H + um_th(CO) - 1) / um_th(CO)) *
                          ((W + UM_TW - 1) / UM_TW);
  if (reinterpret_cast<uintptr_t>(wt) % 16 != 0)  // float4 weight reads
    return cudaErrorInvalidValue;
  if (tiles >= n_sm)
    return launch_upconv_mma<CO, 4>(x, wt, bias, out, B, H, W, Ci, dev,
                                    stream);
  return launch_upconv_mma<CO, 2>(x, wt, bias, out, B, H, W, Ci, dev,
                                  stream);
}

// ------------------------------------------------------ wide: conv_gemm.cuh

// The stored float32 transpose-conv weight Wt (Ci, CO, 4, 4) into
// conv_gemm.cuh's layout rounded to T: slot (phase (r, s), tap (a, b)) =
// (2r + s) * 4 + 2a + b holds Wt[:, :, 3-2a-r, 3-2b-s]; bf16
// [slot][co][cip], float32 [slot][cip][co], zero past Ci. A thread takes
// two channels of one co, whose 16 taps are contiguous in the source.
template <typename T>
__global__ void prep_wt(const float* __restrict__ wt, T* __restrict__ dst,
                        int Ci, int cip, int CO) {
  const int half = cip / 2;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < CO * half;
       e += gridDim.x * blockDim.x) {
    const int co = e / half, ci = 2 * (e % half);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int ry = 3 - k / 4, rx = 3 - k % 4;  // 2a + r, 2b + s
      const int slot = ((ry & 1) * 2 + (rx & 1)) * 4 + (ry >> 1) * 2 +
                       (rx >> 1);
      const float v0 =
          ci < Ci ? __ldg(wt + ((size_t)ci * CO + co) * 16 + k) : 0.0f;
      const float v1 =
          ci + 1 < Ci ? __ldg(wt + ((size_t)(ci + 1) * CO + co) * 16 + k)
                      : 0.0f;
      if constexpr (std::is_same<T, float>::value) {
        dst[((size_t)slot * cip + ci) * CO + co] = v0;
        dst[((size_t)slot * cip + ci + 1) * CO + co] = v1;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(
            dst + ((size_t)slot * CO + co) * cip + ci) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// A wide stage: wbuf holds 16 CO cip elements of T (cip = Ci rounded up
// to GEMM_K).
template <typename T>
cudaError_t launch_upconv_gemm(const void* x, const void* wt,
                               const void* bias, void* out, void* wbuf,
                               int B, int H, int W, int Ci, int CO,
                               cudaStream_t stream) {
  const int cip = (Ci + GEMM_K - 1) / GEMM_K * GEMM_K;
  const long long M = (long long)B * H * W;
  if (M > 0x7fffffff) return cudaErrorInvalidValue;
  T* wp = static_cast<T*>(wbuf);
  prep_wt<T><<<(CO * cip / 2 + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(wt), wp, Ci, cip, CO);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const ConvArgs a = {x, wp, static_cast<const float*>(bias), out, H, W,
                      Ci, cip, CO, H, W, (int)M};
  return CO % 128 ? launch_conv_gemm<CONV_UP, T, 64>(a, stream)
                  : launch_conv_gemm<CONV_UP, T, 128>(a, stream);
}

}  // namespace qpw

extern "C" int qpw_upconv_stage(const void* x, const void* wt,
                                const void* bias, void* out, void* wbuf,
                                int B, int H, int W, int Ci, int Co,
                                int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || Ci < 1) return cudaErrorInvalidValue;
  // The wrapper passes the GEMM's scratch at the wide widths
  // (ops/cuda/upconv_kernel.py:UPCONV_GEMM_CHANNELS) and null otherwise.
  if (wbuf && dtype == 0)
    return qpw::launch_upconv_gemm<float>(x, wt, bias, out, wbuf, B, H, W,
                                          Ci, Co, s);
  if (wbuf && dtype == 1)
    return qpw::launch_upconv_gemm<qpw::bf16>(x, wt, bias, out, wbuf, B, H,
                                              W, Ci, Co, s);
  if (dtype == 0 && Co == 16)
    return qpw::launch_upconv_f32<16>(x, wt, bias, out, B, H, W, Ci, s);
  if (dtype == 0 && Co == 32)
    return qpw::launch_upconv_f32<32>(x, wt, bias, out, B, H, W, Ci, s);
  if (dtype == 1 && Co == 16)
    return qpw::launch_upconv_bf16<16>(x, wt, bias, out, B, H, W, Ci, s);
  if (dtype == 1 && Co == 32)
    return qpw::launch_upconv_bf16<32>(x, wt, bias, out, B, H, W, Ci, s);
  return cudaErrorInvalidValue;
}
