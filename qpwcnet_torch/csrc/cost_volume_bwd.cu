// K4a / K4b: the cost-volume backward, from the pre-activation gradient
// dacc (B,H,W,81) = g * (out > 0 ? 1 : 0.1):
//
//   K4a  dprv[b,y,x,c] = (1/C) sum_k dacc[b,y,x,k]       * nxt[b,y+di,x+dj,c]
//   K4b  dnxt[b,u,v,c] = (1/C) sum_k dacc[b,u-di,v-dj,k] * prv[b,u-di,v-dj,c]
//
// di, dj in [-4, 4], k = (di+4)*9 + (dj+4); maps are zero outside the
// image, so K4b counts source pixels inside the image only. NHWC and
// contiguous. Replaces qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:
// _cv_bwd_prv_kernel (via _cv_bwd_prv_impl) and _cv_bwd_nxt_kernel (via
// _cv_bwd_nxt_impl). K4b is the scatter of dacc * prv onto the displaced
// pixels written as a gather, so no sum needs atomics.
//
// Haloed modes (the spatial H-sharded path's, where nxt carries 4 rows
// exchanged from the neighbouring shards above and below the image):
//  - K4a with nxt_halo = 4 (_cv_bwd_prv_impl(nxt_h_haloed=True)): nxt is
//    (B, H + 8, W, C), image row y at row y + 4, and its window rows are
//    read there instead of zero-padded (the staging's source row shift sh);
//  - K4b with out_halo = 4 (_cv_bwd_nxt_impl(h_haloed_out=True)): dnxt is
//    (B, H + 8, W, C), row u standing for image row u - 4: the gradient of
//    the halo rows too, which the exchange's backward returns to their
//    owners. The grid covers the H + 8 output rows (the output row offset
//    oh); source pixels (u - 4 - di, .) outside [0, H) add nothing, as
//    the plain mode's zero padding does.
// The products and their order are the plain modes'.
//
// What bounds them on the H100: bytes, as for K1 (cost_volume.cu). A
// pixel reads 81 dacc values and C map values and writes C: 81·C
// multiply-adds for 162 + 4·C bytes, under the tensor cores' ridge.
//
// bfloat16 body (cv_bwd_mma_kernel<REVERSED, TY>): K1's banded product
// with the roles of the 81-value and the C-channel maps swapped, on
// mma.sync m16n8k16 with bf16 operands and float32 sums.
//  - The band, with pixels on N. For one output row, 8 output pixels
//    x0..x0+7 and one displacement row di, window column q (0..15) is
//    image column x0-4+q, and
//      D[c][p] += sum_q A[c][q] B[q][p]     (channels M, window K, pixels N)
//    with B zero off the band 0 <= q - p <= 8:
//      K4a  A[c][q] = nxt[y+di, x0-4+q, c]
//           B[q][p] = dacc[y, x0+p, (di+4)*9 + (q-p)]        (output pixel)
//      K4b  A[c][q] = prv[u-di, x0-4+q, c]
//           B[q][p] = dacc[u-di, x0-4+q, (di+4)*9 + 8-(q-p)] (window pixel,
//                                                   displacement reversed)
//    72 of the 128 products are used (56%, as in K1). The nine di add
//    into one sum, since the output does not depend on di: 18 mma a
//    16-channel tile of a run.
//  - The band lives in registers. It does not depend on the channel: a
//    warp owns one output row's 16-pixel run (two n8 tiles, window
//    columns 0-15 and 8-23) and, per displacement row, builds its 2 x 2 B
//    registers from dacc staged in shared memory (unconditional 2-byte
//    loads at offsets fixed but for a lane term, and a mask of the
//    in-band, in-image halves set once), then runs both m16 tiles of its
//    channels on them. A is the staged [pixel][channel] window read by
//    ldmatrix .trans (the x4 of columns 0-15 and the x2 of 16-23 give
//    both tiles' A).
//  - Channels are outputs here, not a reduction: a block owns TY output
//    rows (one warp each) of a 16-pixel run and one group of 32 channels,
//    grid.z runs over batch x channel groups, and no sum is split across
//    blocks. The launcher takes 8 rows where that grid gives half the
//    SMs a block, else 4, else 2: the coarse levels (8 x 16 pixels at
//    C = 256, batch 16: 16 runs of 16 x 8 groups) spread over the SMs by
//    their channel groups; dacc is then read once a group, from L2.
//  - One group a block, no ring. A two-stage cp.async ring of 32-channel
//    chunks, with the band's 36 registers built once for all of a
//    block's chunks, measured slower: the levels give a block 1-2 chunks,
//    so the ring had little to overlap, and its 128-137 registers held
//    two blocks an SM. The band built per displacement row takes 80, so
//    three K4a blocks share an SM and overlap each other's copies,
//    products and stores (finest level, device time: K4a 0.0985 ->
//    0.0762 ms, K4b 0.1528 -> 0.1318 ms; NVIDIA H100 80GB HBM3 at 700 W,
//    recorded in PERF.md).
//  - Staging. dacc once a block: K4a the TY output rows' runs (16 pixels),
//    K4b the (TY+8) x 24 window pixels, of each row only the 16-byte
//    units that hold a displacement row's 9 values that the block reads
//    there (TY x 9 of the (TY+8) x 9 row slices). A run of 81-value pixels
//    is 16-byte aligned only where its first pixel index is a multiple of
//    8, so each row's slot sits at the run's global element address mod 8
//    and whole 16-byte units go by cp.async (elements by the tensor's ends
//    one by one); the columns outside the image are copied but never read
//    (the band's mask puts zeros there). The C-channel map's haloed
//    (TY+8) x 24 window goes by 16-byte cp.async, zero-filled outside the
//    image and past C (cp.async with 0 source bytes), in the same commit
//    group. Pixel stride 40 bf16 (80 bytes), so ldmatrix's rows fall in
//    distinct banks. Where C % 8 != 0 or a map is not 16-byte aligned the
//    window is staged by guarded element loads and the outputs stored
//    element by element: every bf16 call runs this body. Shared memory at
//    8 rows: K4a 51.6 KB (three blocks an SM), K4b 93.2 KB (its haloed
//    dacc: two).
//  - Epilogue: each lane scales its sums D[c][p] by 1/C in float32 and
//    rounds once to bf16 (the plain versions' rounding points,
//    ops/cost_volume.py) into its warp's [16 pixels][channel] tile, which
//    takes the dacc region's place after a barrier; each pixel's 32
//    channels then go out by 16-byte stores.
// Against the TPU kernels: they round each product to the input dtype
// before the float32 sum; this body and the plain versions sum exact
// products (tests/test_torch_kernels_plain.py holds the two).
//
// float32 body: cv_bwd_kernel<float, REVERSED> on the CUDA cores, so that
// float32 stays within 1e-5 of the plain versions (TF32 products would
// not). One thread owns one output pixel and holds its 81 coefficients
// (K4a: dacc at the pixel; K4b: dacc[k] at the 81 source pixels) in
// registers, and per chunk of CV_CC channels reads the haloed
// (TY+8) x (TX+8) window of the C-channel map from shared memory, as K1's
// float32 body does (correlate.cuh); grid.z splits the channels into
// groups of CVB_CG. Products are float32 (exact for bf16), sums float32
// in k order (fmaf), scaled by 1/C and rounded once.
#include <stdint.h>

#include <atomic>

#include "correlate.cuh"
#include "mma.cuh"

namespace qpw {

constexpr int CVB_CG = 32;  // float32 body: channels per block

template <typename T, bool REVERSED>
__global__ void __launch_bounds__(CV_THREADS)
cv_bwd_kernel(const T* __restrict__ dacc, const T* __restrict__ src,
              T* __restrict__ out, int H, int W, int C, int n_groups, int sh,
              int oh) {
  __shared__ float win[CV_CC][CV_WY][CV_WXP];

  const int b = blockIdx.z / n_groups;
  const int c_begin = (blockIdx.z % n_groups) * CVB_CG;
  const int c_end = min(C, c_begin + CVB_CG);
  // image rows: the block's first output row is image row y0 (from -oh)
  const int x0 = blockIdx.x * CV_TX;
  const int y0 = blockIdx.y * CV_TY - oh;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * CV_TX + tx;
  const int x = x0 + tx, y = y0 + ty;
  const bool live = x < W && y < H + oh;
  const T* db = dacc + (size_t)b * H * W * CV_K;
  const T* sb = src + (size_t)b * (H + 2 * sh) * W * C;

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
  T* o = out + (((size_t)b * (H + 2 * oh) + y + oh) * W + x) * C;
  for (int c0 = c_begin; c0 < c_end; c0 += CV_CC) {
    // Stage the window, channel fastest across threads.
    for (int i = tid; i < CV_WY * CV_WX * CV_CC; i += CV_THREADS) {
      const int cc = i % CV_CC;
      const int p = i / CV_CC;
      const int wy = p / CV_WX, wx = p % CV_WX;
      // the src row of image row y0 - CV_R + wy
      const int gy = y0 - CV_R + wy + sh, gx = x0 - CV_R + wx, c = c0 + cc;
      win[cc][wy][wx] = (c < c_end && gy >= 0 && gy < H + 2 * sh && gx >= 0 &&
                         gx < W)
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
                          int B, int H, int W, int C, int sh, int oh,
                          cudaStream_t stream) {
  const int n_groups = (C + CVB_CG - 1) / CVB_CG;
  const dim3 grid((W + CV_TX - 1) / CV_TX,
                  (H + 2 * oh + CV_TY - 1) / CV_TY, B * n_groups);
  const dim3 block(CV_TX, CV_TY);
  cv_bwd_kernel<T, REVERSED><<<grid, block, 0, stream>>>(
      static_cast<const T*>(dacc), static_cast<const T*>(src),
      static_cast<T*>(out), H, W, C, n_groups, sh, oh);
  return cudaGetLastError();
}

constexpr int CB_TX = 16;                // pixels of a warp's run
constexpr int CB_CC = 32;                // channels a block
constexpr int CB_PS = CB_CC + 8;         // pixel stride in shared memory, bf16
constexpr int CB_WX = CB_TX + 2 * CV_R;  // 24 window columns

template <bool REVERSED, int TY>
struct CbCfg {
  static constexpr int NT = TY * 32;                   // one warp a row
  static constexpr int WIN = (TY + 2 * CV_R) * CB_WX;  // window pixels
  // dacc: K4a the output rows' runs, K4b the window's rows; a row's slot
  // holds its run shifted by up to 7 elements, in whole 16-byte units
  static constexpr int DROWS = REVERSED ? TY + 2 * CV_R : TY;
  static constexpr int DPX = REVERSED ? CB_WX : CB_TX;
  static constexpr int DSLOT = (DPX * CV_K + 7 + 7) / 8 * 8;
  // shared memory, bf16: the window, then the dacc slots
  static constexpr int WIN_EL = WIN * CB_PS;
  static constexpr int SMEM = (WIN_EL + DROWS * DSLOT) * (int)sizeof(bf16);
  static_assert(TY * CB_TX * CB_PS <= DROWS * DSLOT,
                "the output tiles fit in the dacc region");
};

template <bool REVERSED, int TY>
__global__ void __launch_bounds__(CbCfg<REVERSED, TY>::NT, 2)
cv_bwd_mma_kernel(const bf16* __restrict__ dacc, const bf16* __restrict__ src,
                  bf16* __restrict__ out, int H, int W, int C, int n_groups,
                  int vec, int sh, int oh) {
  using Cfg = CbCfg<REVERSED, TY>;
  extern __shared__ __align__(16) unsigned char cb_smem[];
  bf16* const wsm = reinterpret_cast<bf16*>(cb_smem);
  bf16* const dsm = wsm + Cfg::WIN_EL;

  const int b = blockIdx.z / n_groups;
  const int c0 = (blockIdx.z % n_groups) * CB_CC;
  const int c_end = min(C, c0 + CB_CC);
  // image rows: the block's first output row is image row y0 (from -oh)
  const int x0 = blockIdx.x * CB_TX, y0 = blockIdx.y * TY - oh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // dacc row r of the block: its image row, the global element index of
  // its run's first value (negative before the tensor) and its slot shift
  const long long d_total = (long long)(gridDim.z / n_groups) * H * W * CV_K;
  const unsigned long long d_el = reinterpret_cast<uintptr_t>(dacc) / 2;
  auto drow_y = [&](int r) { return REVERSED ? y0 - CV_R + r : y0 + r; };
  auto drow_start = [&](int r) {
    return (((long long)b * H + drow_y(r)) * W + (REVERSED ? x0 - CV_R : x0))
           * CV_K;
  };
  auto shift_of = [&](long long e) {
    return (int)((d_el + (unsigned long long)e) & 7);
  };

  // dacc: whole 16-byte units of each row's run, a warp a row; the units
  // by the tensor's two ends element by element. Rows outside the image
  // are not read. K4b's window row r is read by the displacement rows i in
  // [8 - r, TY + 7 - r] only: the units that hold none of their 9-value
  // slices [9 i, 9 i + 8] of any pixel are skipped (TY x 9 slices a
  // column of the block instead of (TY + 8) x 9).
  {
    constexpr int N_EL = Cfg::DPX * CV_K;
    for (int r = warp; r < Cfg::DROWS; r += TY) {
      const int gy = drow_y(r);
      if (gy < 0 || gy >= H) continue;
      const long long e_s = drow_start(r);
      const int sh = shift_of(e_s);
      const int klo = REVERSED ? max(0, 2 * CV_R - r) * CV_D : 0;
      const int khi =
          REVERSED ? min(2 * CV_R, TY + 2 * CV_R - 1 - r) * CV_D + CV_D - 1
                   : CV_K - 1;
      bf16* const slot = dsm + r * Cfg::DSLOT;
      for (int u = lane; u < (sh + N_EL + 7) / 8; u += 32) {
        const int el0 = 8 * u - sh;  // run-relative, -7 to N_EL - 1
        if (REVERSED) {
          const int a = max(el0, 0), z = min(el0 + 7, N_EL - 1);
          const int ka = a % CV_K, kz = z % CV_K;
          if (a / CV_K == z / CV_K ? ka > khi || kz < klo
                                   : ka > khi && kz < klo)
            continue;
        }
        const long long e0 = e_s + el0;
        bf16* dst = slot + 8 * u;
        if (e0 >= 0 && e0 + 8 <= d_total) {
          cp_async16(dst, dacc + e0, 16);
        } else {
          for (int e = 0; e < 8; ++e)
            if (e0 + e >= 0 && e0 + e < d_total) dst[e] = dacc[e0 + e];
        }
      }
    }
  }
  // The block's 32 channels of the C-channel window, 4 segments of 8 a
  // pixel; zeros outside the map's rows (the image's, and K4a's supplied
  // halo rows) and columns and past C.
  {
    const bf16* const sb = src + (size_t)b * (H + 2 * sh) * W * C;
    for (int i = tid; i < Cfg::WIN * 4; i += Cfg::NT) {
      const int pix = i >> 2, c = c0 + (i & 3) * 8;
      const int gy = y0 - CV_R + sh + pix / CB_WX;
      const int gx = x0 - CV_R + pix % CB_WX;
      const bool in =
          gy >= 0 && gy < H + 2 * sh && gx >= 0 && gx < W && c < C;
      const bf16* g = in ? sb + ((size_t)gy * W + gx) * C + c : sb;
      bf16* dst = wsm + pix * CB_PS + (i & 3) * 8;
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
  cp_async_commit();

  const int ty = warp, y = y0 + ty;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row addresses (K1's): lanes 0-7 and 8-15 give window columns
  // 0-7 at channel offsets 0 and 8, lanes 16-31 columns 8-15 likewise; the
  // x2 load of columns 16-23 uses lanes 0-15. Transposed, the four 8x8
  // blocks are A's a0-a3 of columns 0-15.
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lk = ((lane >> 3) & 1) * 8;

  // The band: B[q][p] of tile j at a lane's k = q = 2t + 8h + {0, 1}
  // (register h, low half first) and p = g. Its offset jj = q - p and the
  // image column of the dacc pixel it reads (K4a the output pixel 8j + g,
  // K4b the window pixel 8j + q) do not depend on the displacement row, so
  // each register's mask of the in-band, in-image halves is set once.
  uint32_t mask[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mask[j][h] = 0u;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * t + 8 * h + e, jj = q - g;
        const int gx = REVERSED ? x0 - CV_R + 8 * j + q : x0 + 8 * j + g;
        if (jj >= 0 && jj <= 2 * CV_R && gx >= 0 && gx < W)
          mask[j][h] |= 0xffffu << (16 * e);
      }
    }
  // Element offsets in a row's slot, past its shift:
  //   K4a  pixel 8j + g, k = 9i + jj:      648j + 80g + 2t + 9i + 8h + e
  //   K4b  pixel 8j + q, k = 9i + 8 - jj:  648j + 160t + g + 8 + 9i + 640h
  //                                        + 80e
  const unsigned short* const d16 =
      reinterpret_cast<const unsigned short*>(dsm);
  const int lane_off = REVERSED ? 160 * t + g + 8 : 80 * g + 2 * t;

  float acc[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.0f;

  cp_async_wait_all();
  __syncthreads();
  const uint32_t win = smem_addr(wsm);
#pragma unroll
  for (int i = 0; i < CV_D; ++i) {
    // K4a: dacc at the output row, the map at row y + di; K4b: both at the
    // source row u - di
    const int r = REVERSED ? ty + 2 * CV_R - i : ty;
    const int wy = REVERSED ? ty + 2 * CV_R - i : ty + i;
    const int gy = drow_y(r);
    const uint32_t row_mask = gy >= 0 && gy < H ? 0xffffffffu : 0u;
    const unsigned short* const d =
        d16 + r * Cfg::DSLOT + shift_of(drow_start(r)) + lane_off + 9 * i;
    uint32_t band[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o0 = 648 * j + (REVERSED ? 640 * h : 8 * h);
        const int o1 = o0 + (REVERSED ? 80 : 1);
        band[j][h] = ((uint32_t)d[o0] | (uint32_t)d[o1] << 16) &
                     mask[j][h] & row_mask;
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (c0 + mt * 16 < C) {
        const uint32_t row = win + ((wy * CB_WX) * CB_PS + mt * 16 + lk) * 2;
        uint32_t a4[4], a2[2];
        ldmatrix_x4_trans(a4, row + lrow * CB_PS * 2);
        ldmatrix_x2_trans(a2, row + (16 + (lane & 7)) * CB_PS * 2);
        const uint32_t a1[4] = {a4[2], a4[3], a2[0], a2[1]};
        mma_bf16(acc[mt][0], a4, band[0][0], band[0][1]);
        mma_bf16(acc[mt][1], a1, band[1][0], band[1][1]);
      }
    }
  }
  // every warp is done with dacc: the output tiles take its place
  __syncthreads();

  // A lane's sum r of tile j, m-tile mt: channel mt*16 + g (+8 for
  // r >= 2), pixel 8j + 2t + (r & 1); this warp's tile is
  // [16 pixels][CB_PS].
  bf16* const so = dsm + ty * CB_TX * CB_PS;
  const float inv_c = 1.0f / (float)C;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        so[(8 * j + 2 * t + (r & 1)) * CB_PS + mt * 16 + g + (r & 2) * 4] =
            __float2bfloat16_rn(acc[mt][j][r] * inv_c);
  __syncwarp();
  if (y < H + oh) {
    for (int u = lane; u < CB_TX * 4; u += 32) {
      const int px = u >> 2, c = c0 + (u & 3) * 8;
      const int x = x0 + px;
      if (x >= W || c >= c_end) continue;
      const bf16* s = so + px * CB_PS + (u & 3) * 8;
      bf16* dst =
          out + (((size_t)b * (H + 2 * oh) + y + oh) * W + x) * C + c;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(s);
      } else {
        for (int e = 0; e < 8 && c + e < c_end; ++e) dst[e] = s[e];
      }
    }
  }
}

template <bool REVERSED, int TY>
cudaError_t launch_cvb_mma(const void* dacc, const void* src, void* out,
                           int B, int H, int W, int C, int sh, int oh,
                           int dev, cudaStream_t stream) {
  using Cfg = CbCfg<REVERSED, TY>;
  auto kern = cv_bwd_mma_kernel<REVERSED, TY>;
  // the dynamic shared-memory limit, once a device (one bit each)
  static std::atomic<unsigned> limit_set{0};
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(limit_set.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    limit_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const int n_groups = (C + CB_CC - 1) / CB_CC;
  const int ny = (H + 2 * oh + TY - 1) / TY;
  if (ny > 65535 || (long long)B * n_groups > 65535)
    return cudaErrorInvalidValue;
  const int vec = C % 8 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                                  reinterpret_cast<uintptr_t>(out)) %
                                 16) == 0;
  kern<<<dim3((W + CB_TX - 1) / CB_TX, ny, B * n_groups), Cfg::NT,
         Cfg::SMEM, stream>>>(static_cast<const bf16*>(dacc),
                              static_cast<const bf16*>(src),
                              static_cast<bf16*>(out), H, W, C, n_groups,
                              vec, sh, oh);
  return cudaGetLastError();
}

// The tile height: 8 rows where the grid gives half the SMs a block, else
// 4 rows where it does, else 2 rows. (At (16,8,16,256), 128 blocks of 8
// rows took 3.8 / 5.5 µs of device time (K4a / K4b), 512 of 2 rows 4.9 /
// 14.4; NVIDIA H100 80GB HBM3 at 700 W, recorded in PERF.md.)
template <bool REVERSED>
cudaError_t launch_cvb_bf16(const void* dacc, const void* src, void* out,
                            int B, int H, int W, int C, int sh, int oh,
                            cudaStream_t stream) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long cols = (long long)B * ((W + CB_TX - 1) / CB_TX) *
                         ((C + CB_CC - 1) / CB_CC);
  auto blocks = [&](int ty) { return cols * ((H + 2 * oh + ty - 1) / ty); };
  if (2 * blocks(8) >= n_sm)
    return launch_cvb_mma<REVERSED, 8>(dacc, src, out, B, H, W, C, sh, oh,
                                       dev, stream);
  if (2 * blocks(4) >= n_sm)
    return launch_cvb_mma<REVERSED, 4>(dacc, src, out, B, H, W, C, sh, oh,
                                       dev, stream);
  return launch_cvb_mma<REVERSED, 2>(dacc, src, out, B, H, W, C, sh, oh, dev,
                                     stream);
}

template <bool REVERSED>
int dispatch_cv_bwd(const void* dacc, const void* src, void* out, int B,
                    int H, int W, int C, int halo, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || C < 1) return cudaErrorInvalidValue;
  if (halo != 0 && halo != CV_R) return cudaErrorInvalidValue;
  // K4a's halo is its nxt's (the source rows), K4b's its output's
  const int sh = REVERSED ? 0 : halo, oh = REVERSED ? halo : 0;
  if (dtype == 0)
    return launch_cv_bwd<float, REVERSED>(dacc, src, out, B, H, W, C, sh, oh,
                                          s);
  if (dtype == 1)
    return launch_cvb_bf16<REVERSED>(dacc, src, out, B, H, W, C, sh, oh, s);
  return cudaErrorInvalidValue;
}

}  // namespace qpw

// K4a: dprv from dacc and nxt; H is dacc's rows, nxt has H + 2 nxt_halo
// (0, or 4 for the haloed mode).
extern "C" int qpw_cost_volume_bwd_prv(const void* dacc, const void* nxt,
                                       void* dprv, int B, int H, int W, int C,
                                       int nxt_halo, int dtype, void* stream) {
  return qpw::dispatch_cv_bwd<false>(dacc, nxt, dprv, B, H, W, C, nxt_halo,
                                     dtype, stream);
}

// K4b: dnxt from dacc and prv; H is dacc's rows, dnxt has H + 2 out_halo
// (0, or 4 for the haloed mode).
extern "C" int qpw_cost_volume_bwd_nxt(const void* dacc, const void* prv,
                                       void* dnxt, int B, int H, int W, int C,
                                       int out_halo, int dtype, void* stream) {
  return qpw::dispatch_cv_bwd<true>(dacc, prv, dnxt, B, H, W, C, out_halo,
                                    dtype, stream);
}
