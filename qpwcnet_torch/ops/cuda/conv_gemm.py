"""The wide stages' implicit GEMM (``csrc/conv_gemm.cuh``) in plain
PyTorch, and what its bf16 body takes.

K2 at encoder stages 2-4 and K5 at decoder stages 0-1 run one implicit
GEMM a conv on the card: ``out[m][n] = Mish(bias[n] + sum_{tap, ci}
x[pixel(m, tap)][ci] * W[slot][n][ci])``. Its bf16 body reads each K step
of A as one TMA box of the NHWC input, shifted by the tap, with zeros out
of bounds; the stride-2 conv reads the input through a 5D view of the same
memory, ``(B, H/2, 2, W/2, 2C)``, whose element ``[b, yy, py, xx, px C +
c]`` is pixel ``(2yy + py, 2xx + px)``. :func:`conv_gemm_plain` computes
one conv by that decomposition (the same views, the same per-tap origins,
the prepared weights' slot order, ``prep_w33`` / ``prep_wt`` of
``csrc/stem.cu`` and ``csrc/upconv.cu``), so a test can hold it against
the stages' plain versions and the JAX package, and the card tests
(``tests/test_torch_cuda.py``) can hold the kernel against it. Nothing on the main path calls it.

TMA reads a tensor from a 16-byte-aligned address with 16-byte strides,
and a stride-2 box of C channels must not run into the next pixel's: so
the bf16 body takes inputs of a multiple of 32 channels at an aligned
address (every width of the models). The wrappers give it an aligned,
channel-padded copy of any other input (:func:`tma_padded`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qpwcnet_torch.layout import nchw, nhwc
from qpwcnet_torch.ops.cuda import mish_kernel
from qpwcnet_torch.ops.cuda._build import GEMM_K, gemm_cip

# csrc/conv_gemm.cuh's modes: a 3x3 stride-2 SAME conv on an even input,
# a 3x3 stride-1 SAME conv, the 4x4 stride-2 transpose conv's 4 phases
CONV_S2, CONV_S1, CONV_UP = 0, 1, 2
TAPS = {CONV_S2: 9, CONV_S1: 9, CONV_UP: 4}


def tma_ready(x: torch.Tensor) -> bool:
    """Whether the bf16 GEMM can read x (..., C) as it is: C a multiple
    of GEMM_K (32; a K step is 64 channels, or 32), 16-byte aligned."""
    return x.shape[-1] % GEMM_K == 0 and x.data_ptr() % 16 == 0


def tma_padded(x: torch.Tensor) -> torch.Tensor:
    """A new, aligned copy of x (..., C) with its channels zero-padded to
    a multiple of GEMM_K."""
    c = x.shape[-1]
    return F.pad(x, (0, gemm_cip(c) - c)) if gemm_cip(c) > c else x.clone()


def tma_input(x: torch.Tensor, weight: torch.Tensor, ci_dim: int):
    """x and its weight as the bf16 GEMM takes them: unchanged if
    :func:`tma_ready`, else x's aligned, channel-padded copy and the
    weight zero-padded to match along its input-channel dimension."""
    if tma_ready(x):
        return x, weight
    xp = tma_padded(x)
    pad = [0, 0] * (weight.ndim - 1 - ci_dim) + [0, xp.shape[-1] - x.shape[-1]]
    return xp, F.pad(weight, pad)


def prep_w33_plain(weight: torch.Tensor, cip: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """``prep_w33``'s layout of one 3x3 conv: the OIHW weight (Co, Ci, 3,
    3) as (9 taps, Co, cip) in ``dtype``, tap = 3 dy + dx, zeros past
    Ci."""
    co, ci = weight.shape[:2]
    w = weight.permute(2, 3, 0, 1).reshape(9, co, ci)
    return F.pad(w, (0, cip - ci)).to(dtype)


def prep_wt_plain(weight: torch.Tensor, cip: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """``prep_wt``'s layout of the transpose conv's stored weight (Ci, Co,
    4, 4): (16 slots, Co, cip) in ``dtype``, slot (phase (r, s), tap (a,
    b)) = (2r + s) 4 + 2a + b holding ``Wt[:, :, 3 - 2a - r, 3 - 2b -
    s]``, zeros past Ci."""
    ci = weight.shape[0]
    slots = [weight[:, :, 3 - 2 * a - r, 3 - 2 * b - s].t()
             for r in (0, 1) for s in (0, 1) for a in (0, 1) for b in (0, 1)]
    return F.pad(torch.stack(slots), (0, cip - ci)).to(dtype)


def _a_taps(mode: int, x: torch.Tensor, phase: int) -> list[torch.Tensor]:
    """The K steps' A blocks of one phase, each (B, Hp, Wp, C): the boxes
    at the positions' origin shifted by the tap, zero out of bounds."""
    b, h, w, c = x.shape
    if mode == CONV_S2:
        # [b, yy, py, xx, px C + c]; the padding is yy = H/2 and xx = W/2
        v = F.pad(x.reshape(b, h // 2, 2, w // 2, 2 * c),
                  (0, 0, 0, 1, 0, 0, 0, 1))
        return [v[:, dy // 2:dy // 2 + h // 2, dy % 2,
                  dx // 2:dx // 2 + w // 2, (dx % 2) * c:(dx % 2 + 1) * c]
                for dy in range(3) for dx in range(3)]
    v = F.pad(x, (0, 0, 1, 1, 1, 1))  # origin -1: index 0 is the padding
    if mode == CONV_S1:
        return [v[:, dy:dy + h, dx:dx + w] for dy in range(3)
                for dx in range(3)]
    r, s = phase >> 1, phase & 1
    return [v[:, a + r:a + r + h, bb + s:bb + s + w] for a in (0, 1)
            for bb in (0, 1)]


def conv_gemm_plain(mode: int, x: torch.Tensor, w_prepared: torch.Tensor,
                    bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One conv + bias + Mish as ``csrc/conv_gemm.cuh`` decomposes it.

    x: (B, H, W, Ci) NHWC; w_prepared: (slots, Co, cip) from
    :func:`prep_w33_plain` or :func:`prep_wt_plain`; bias (Co,) float32.
    A is built per K step from shifted views of x (no im2col), the
    products are summed in float32, rounded to ``dtype``, the bias added
    and Mish applied in ``dtype``. Returns (B, H/2, W/2, Co) for
    ``CONV_S2``, (B, H, W, Co) for ``CONV_S1`` and (B, 2H, 2W, Co) for
    ``CONV_UP``, phase (r, s) of position (i, j) at pixel (2i + r, 2j +
    s).
    """
    slots, co, cip = w_prepared.shape
    b, h, w, c = x.shape
    xd = F.pad(x.to(dtype), (0, cip - c))  # zeros past Ci
    ntap = TAPS[mode]
    phases = []
    for ph in range(slots // ntap):
        a = torch.cat(_a_taps(mode, xd, ph), -1)
        hp, wp = a.shape[1:3]
        wk = w_prepared[ph * ntap:(ph + 1) * ntap]
        y = a.reshape(-1, ntap * cip).float() @ (
            wk.permute(0, 2, 1).reshape(ntap * cip, co).float())
        y = y.to(dtype).reshape(b, hp, wp, co)
        phases.append(nhwc(mish_kernel.bias_mish_cuda(nchw(y), bias)))
    if mode != CONV_UP:
        return phases[0]
    out = phases[0].new_empty((b, 2 * h, 2 * w, co))
    for ph, y in enumerate(phases):
        out[:, ph >> 1::2, ph & 1::2] = y
    return out


def downconv_stage_gemm_plain(x, params, dtype: torch.dtype) -> torch.Tensor:
    """K2's wide stage as the card runs it: conv_a (``CONV_S2``), conv_aa
    and conv_b (``CONV_S1``), each one :func:`conv_gemm_plain`."""
    y = x
    for k, (weight, bias) in enumerate(params):
        y = conv_gemm_plain(
            CONV_S2 if k == 0 else CONV_S1, y,
            prep_w33_plain(weight, gemm_cip(y.shape[-1]), dtype), bias,
            dtype)
    return y


def upconv_stage_gemm_plain(x, weight, bias, dtype: torch.dtype):
    """K5's wide stage as the card runs it: one ``CONV_UP``
    :func:`conv_gemm_plain` over the four phases."""
    return conv_gemm_plain(
        CONV_UP, x, prep_wt_plain(weight, gemm_cip(x.shape[-1]), dtype), bias,
        dtype)
