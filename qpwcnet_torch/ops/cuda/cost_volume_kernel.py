"""K1: the cost-volume forward, and K4a / K4b: its backward, as CUDA
kernels (``csrc/cost_volume.cu``, ``csrc/correlate.cuh``,
``csrc/mma.cuh``, ``csrc/cost_volume_bwd.cu``).

Replaces: ``qpwcnet_tpu/ops/pallas/cost_volume_kernel.py:_cv_kernel``
(via ``_cost_volume_pallas_impl``), ``_cv_bwd_prv_kernel`` (via
``_cv_bwd_prv_impl``) and ``_cv_bwd_nxt_kernel`` (via
``_cv_bwd_nxt_impl``). ``ops/cost_volume.py:CostVolumeFunction`` joins
them into the trainable op.

What bounds K1 on the H100: bytes. A pixel reads 2·C input values and
writes 81 (at C = 32, 128 bytes in and 162 out in bf16), for 81·C
multiply-adds: 18 to 80 operations a byte over the model's levels, under
the tensor cores' ridge (~295) and not under the CUDA cores' (~20). The
plain version reads the padded nxt map once per displacement (81 times)
and writes 81 float32 planes before the stack.

bf16 runs ``cost_volume_mma_kernel`` (``csrc/cost_volume.cu``, whose note
has the whole design) on the tensor cores: for 8 pixels of a row and one
displacement row, the nine offsets are the band of one 16 x 8
``mma.sync`` product of 16 nxt window columns (M) by the 8 prv pixels
(N) over the channels; a warp holds a 16-pixel run, a block stages the
prv tile and the haloed nxt window by ``cp.async`` in a two-stage ring
and stores each row's 81-value outputs by 16-byte stores from a shared
tile; smaller tiles keep the coarse levels spread over the SMs. float32
runs the CUDA-core ``correlate_kernel<float, false>``
(``csrc/correlate.cuh``; one pixel a thread, bound by its shared-memory
loads), since TF32 products would not stay within 1e-5 of the plain
version.

K4a and K4b have K1's bound, and their bf16 body (``cv_bwd_mma_kernel``
in ``csrc/cost_volume_bwd.cu``, whose note has the whole design) is K1's
banded product with the roles swapped: for 8 output pixels of a row and
one displacement row, the nine offsets are the band of one 16 x 8
``mma.sync`` product of 16 channels (M) by 16 window columns (K) by the 8
pixels (N), the band B built in registers from dacc staged by
``cp.async`` (K4a: dacc at the output pixel; K4b: at the window pixel,
with the displacement reversed), the window read by ``ldmatrix .trans``.
Channels are outputs, so a block owns one group of 32 and grid.z runs
over the groups, which spreads the coarse levels over the SMs without
atomics. float32 runs the CUDA-core
``cv_bwd_kernel<float, ...>``: each thread holds the 81 dacc coefficients
of its output pixel in registers and correlates them against a
shared-memory window of the C-channel map. K4b is the scatter of
dacc·prv onto the displaced pixels written as a gather (each output
pixel reads its 81 source pixels), so it needs no atomics. The plain
versions make 81 float32 passes over (B, H, W, C) maps. Products are
exact and sums float32 in both bodies (the TPU kernel rounds each
product to the input dtype before its float32 sum).

K1's unhaloed launch is the custom op ``qpwcnet::cost_volume``
(``torch.library``, CUDA only) with a fake implementation (the plain
version's shape and dtype) and a flop formula (2·81·C multiply-adds a
pixel), so ``torch.export`` traces it into a program (a loaded program
needs this module imported first, to register the op) and
``FlopCounterMode`` counts it.
"""

from __future__ import annotations

import torch

from qpwcnet_torch.ops.cost_volume import (
    cost_volume_bwd_nxt_plain,
    cost_volume_bwd_prv_plain,
    cost_volume_plain,
    cost_volume_plain_haloed,
)
from qpwcnet_torch.ops.cuda import _build
from qpwcnet_torch.utils import tracing
from torch.utils.flop_counter import register_flop_formula

SEARCH_RANGE = 4  # the kernels' compiled search range (81 outputs)
N_DISP = (2 * SEARCH_RANGE + 1) ** 2


def _launch_fwd(prv: torch.Tensor, nxt: torch.Tensor, search_range: int,
                halo: int) -> torch.Tensor:
    """Validate, allocate the (B, H, W, 81) output and launch K1; nxt has
    ``halo`` supplied rows above and below prv's H."""
    if search_range != SEARCH_RANGE:
        raise ValueError(f"the CUDA cost volume is built for search_range="
                         f"{SEARCH_RANGE}, got {search_range}")
    b, h, w, c = prv.shape
    _build.require(prv, "prv")
    _build.require(nxt, "nxt", (b, h + 2 * halo, w, c), prv.dtype,
                   prv.device)
    out = torch.empty((b, h, w, N_DISP), dtype=prv.dtype, device=prv.device)
    lib = _build.library()
    with _build.on_device(prv.device):
        err = lib.qpw_cost_volume(
            prv.data_ptr(), nxt.data_ptr(), out.data_ptr(), b, h, w, c, halo,
            _build.dtype_code(prv.dtype), _build.stream_ptr(prv.device))
    _build.check(err, "qpw_cost_volume")
    return out


@torch.library.custom_op("qpwcnet::cost_volume", mutates_args=(),
                         device_types="cuda")
def cost_volume_op(prv: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """K1 on card tensors (B, H, W, C) x2 -> (B, H, W, 81), search range
    4; counts the launch on :func:`cost_volume_cuda`."""
    out = _launch_fwd(prv, nxt, SEARCH_RANGE, 0)
    tracing.count("launches.cost_volume_cuda")
    return out


@cost_volume_op.register_fake
def _cost_volume_fake(prv: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = prv.shape
    return prv.new_empty((b, h, w, N_DISP))


@register_flop_formula(torch.ops.qpwcnet.cost_volume)
def cost_volume_flops(prv_shape, nxt_shape, *args, out_shape=None,
                      **kwargs) -> int:
    """81 products and sums of C channels a pixel: 2·81·C·B·H·W."""
    b, h, w, c = prv_shape
    return 2 * N_DISP * c * b * h * w


def cost_volume_cuda(prv: torch.Tensor, nxt: torch.Tensor,
                     search_range: int = 4) -> torch.Tensor:
    """Cost volume, NHWC (B, H, W, C) x2 -> (B, H, W, 81).

    CPU tensors take :func:`cost_volume_plain`; CUDA tensors launch the
    kernel (the op ``qpwcnet::cost_volume``) or raise.
    """
    if not prv.is_cuda:
        return cost_volume_plain(prv, nxt, search_range=search_range)
    if search_range != SEARCH_RANGE:
        raise ValueError(f"the CUDA cost volume is built for search_range="
                         f"{SEARCH_RANGE}, got {search_range}")
    return torch.ops.qpwcnet.cost_volume(prv, nxt)


def cost_volume_haloed_cuda(prv: torch.Tensor, nxt_h: torch.Tensor,
                            search_range: int = 4) -> torch.Tensor:
    """K1's haloed mode (``_cost_volume_pallas_impl(nxt_h_haloed=True)``):
    prv (B, H, W, C) against nxt_h (B, H + 2r, W, C), whose H halo the
    caller supplies (rows [r, H + r) aligned to prv's) -> (B, H, W, 81);
    only W is zero-padded.

    CPU tensors take :func:`cost_volume_plain_haloed`; CUDA tensors launch
    the kernel or raise.
    """
    if not prv.is_cuda:
        return cost_volume_plain_haloed(prv, nxt_h, search_range=search_range)
    out = _launch_fwd(prv, nxt_h, search_range, search_range)
    tracing.count("launches.cost_volume_haloed_cuda")
    return out


def _launch_bwd(entry: str, dacc: torch.Tensor, src: torch.Tensor,
                src_name: str, src_halo: int, out_halo: int) -> torch.Tensor:
    """Validate, allocate the gradient and launch one of the backward
    kernels: ``src`` has ``src_halo`` extra rows above and below dacc's H
    (K4a's haloed nxt), the output ``out_halo`` (K4b's haloed dnxt)."""
    _build.require(dacc, "dacc")
    b, h, w, k = dacc.shape
    if k != N_DISP:
        raise ValueError(f"dacc has {k} channels, not {N_DISP}")
    _build.require(src, src_name)
    c = src.shape[-1]
    _build.require(src, src_name, (b, h + 2 * src_halo, w, c), dacc.dtype,
                   dacc.device)
    out = torch.empty((b, h + 2 * out_halo, w, c), dtype=src.dtype,
                      device=src.device)
    lib = _build.library()
    with _build.on_device(src.device):
        err = getattr(lib, entry)(
            dacc.data_ptr(), src.data_ptr(), out.data_ptr(), b, h, w, c,
            src_halo + out_halo, _build.dtype_code(src.dtype),
            _build.stream_ptr(src.device))
    _build.check(err, entry)
    return out


def cost_volume_bwd_prv_cuda(dacc: torch.Tensor,
                             nxt: torch.Tensor) -> torch.Tensor:
    """K4a: dprv from dacc (B, H, W, 81) and nxt (B, H, W, C), both in one
    dtype -> (B, H, W, C) in that dtype.

    CPU tensors take :func:`cost_volume_bwd_prv_plain`; CUDA tensors
    launch the kernel or raise.
    """
    if not dacc.is_cuda:
        return cost_volume_bwd_prv_plain(dacc, nxt)
    out = _launch_bwd("qpw_cost_volume_bwd_prv", dacc, nxt, "nxt", 0, 0)
    tracing.count("launches.cost_volume_bwd_prv_cuda")
    return out


def cost_volume_bwd_prv_haloed_cuda(dacc: torch.Tensor,
                                    nxt_h: torch.Tensor) -> torch.Tensor:
    """K4a's haloed mode (``_cv_bwd_prv_impl(nxt_h_haloed=True)``): dprv
    from dacc (B, H, W, 81) and the haloed nxt_h (B, H + 2r, W, C) ->
    (B, H, W, C).

    CPU tensors take :func:`cost_volume_bwd_prv_plain`; CUDA tensors
    launch the kernel or raise.
    """
    if not dacc.is_cuda:
        return cost_volume_bwd_prv_plain(dacc, nxt_h, nxt_h_haloed=True)
    out = _launch_bwd("qpw_cost_volume_bwd_prv", dacc, nxt_h, "nxt",
                      SEARCH_RANGE, 0)
    tracing.count("launches.cost_volume_bwd_prv_haloed_cuda")
    return out


def cost_volume_bwd_nxt_cuda(dacc: torch.Tensor,
                             prv: torch.Tensor) -> torch.Tensor:
    """K4b: dnxt from dacc (B, H, W, 81) and prv (B, H, W, C), both in one
    dtype -> (B, H, W, C) in that dtype.

    CPU tensors take :func:`cost_volume_bwd_nxt_plain`; CUDA tensors
    launch the kernel or raise.
    """
    if not dacc.is_cuda:
        return cost_volume_bwd_nxt_plain(dacc, prv)
    out = _launch_bwd("qpw_cost_volume_bwd_nxt", dacc, prv, "prv", 0, 0)
    tracing.count("launches.cost_volume_bwd_nxt_cuda")
    return out


def cost_volume_bwd_nxt_haloed_cuda(dacc: torch.Tensor,
                                    prv: torch.Tensor) -> torch.Tensor:
    """K4b's haloed mode (``_cv_bwd_nxt_impl(h_haloed_out=True)``): the
    gradient of a haloed nxt, (B, H + 2r, W, C), row u standing for image
    row u - r, from dacc (B, H, W, 81) and prv (B, H, W, C).

    CPU tensors take :func:`cost_volume_bwd_nxt_plain`; CUDA tensors
    launch the kernel or raise.
    """
    if not dacc.is_cuda:
        return cost_volume_bwd_nxt_plain(dacc, prv, h_haloed_out=True)
    out = _launch_bwd("qpw_cost_volume_bwd_nxt", dacc, prv, "prv", 0,
                      SEARCH_RANGE)
    tracing.count("launches.cost_volume_bwd_nxt_haloed_cuda")
    return out
