// K3: fused warp + correlate: the correlation of correlate.cuh against
// backward_warp(nxt, clamp(flow, +-ww)), built in shared memory by a
// 4-corner gather; the warped map never reaches device memory.
// Replaces qpwcnet_tpu/ops/pallas/warp_cv_kernel.py:_wcv_kernel.
#include "correlate.cuh"

extern "C" int qpw_warp_cost_volume(const void* prv, const void* nxt,
                                    const void* flow, void* out, int B, int H,
                                    int W, int C, float ww, int dtype,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qpw::launch_correlate<float, true>(prv, nxt, flow, out, B, H, W,
                                              C, ww, s);
  if (dtype == 1)
    return qpw::launch_correlate<qpw::bf16, true>(prv, nxt, flow, out, B, H,
                                                  W, C, ww, s);
  return cudaErrorInvalidValue;
}
