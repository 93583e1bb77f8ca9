// K1: cost-volume forward (the correlation of correlate.cuh on nxt).
// Replaces qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:_cv_kernel.
#include "correlate.cuh"

extern "C" int qpw_cost_volume(const void* prv, const void* nxt, void* out,
                               int B, int H, int W, int C, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qpw::launch_correlate<float, false>(prv, nxt, nullptr, out, B, H,
                                               W, C, 0.0f, s);
  if (dtype == 1)
    return qpw::launch_correlate<qpw::bf16, false>(prv, nxt, nullptr, out, B,
                                                   H, W, C, 0.0f, s);
  return cudaErrorInvalidValue;
}
