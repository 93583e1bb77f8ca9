"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version, which CPU
tensors take, and counts the wrapper's launches as the counter
``launches.<wrapper>`` of ``utils/tracing.py``. Nothing here
builds or imports a compiler at import time: ``_build.library()``
compiles ``qpwcnet_torch/csrc/*.cu`` at the first launch.
"""

from qpwcnet_torch.ops.cuda.cost_volume_kernel import (
    cost_volume_bwd_nxt_cuda,
    cost_volume_bwd_nxt_haloed_cuda,
    cost_volume_bwd_prv_cuda,
    cost_volume_bwd_prv_haloed_cuda,
    cost_volume_cuda,
    cost_volume_haloed_cuda,
)
from qpwcnet_torch.ops.cuda.mish_kernel import (
    bias_mish_bwd_cuda,
    bias_mish_cuda,
)
from qpwcnet_torch.ops.cuda.stem_kernel import downconv_stage_cuda
from qpwcnet_torch.ops.cuda.upconv_kernel import upconv_stage_cuda
from qpwcnet_torch.ops.cuda.warp_cv_kernel import warp_cost_volume_cuda
from qpwcnet_torch.utils import tracing

# the haloed modes of K1, K4a and K4b (the spatial path's) count apart;
# the bias + Mish epilogue counts its forward and backward calls
KERNEL_WRAPPERS = (cost_volume_cuda, downconv_stage_cuda,
                   warp_cost_volume_cuda, cost_volume_bwd_prv_cuda,
                   cost_volume_bwd_nxt_cuda, upconv_stage_cuda,
                   cost_volume_haloed_cuda, cost_volume_bwd_prv_haloed_cuda,
                   cost_volume_bwd_nxt_haloed_cuda, bias_mish_cuda,
                   bias_mish_bwd_cuda)
COUNTERS = {fn.__name__: "launches." + fn.__name__ for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    tracing.reset_counts(COUNTERS.values())


def launch_counts() -> dict[str, int]:
    counts = tracing.counts()
    return {name: counts.get(c, 0) for name, c in COUNTERS.items()}
