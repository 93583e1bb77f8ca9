"""Cost-volume correlation (port of qpwcnet_tpu/ops/cost_volume.py).

With search range ``r`` (default 4) and ``d = 2r+1``::

    out[b, i, j, k] = leaky_relu_{0.1}(
        mean_c( prv[b, i, j, c] * nxt[b, i + di, j + dj, c] ) )

where ``k = (di + r) * d + (dj + r)`` and ``nxt`` is zero-padded outside
its bounds. Inputs and output are NHWC; sums are float32 (float64 for
float64 inputs).

Implementations behind one API:
  * :func:`cost_volume_plain` — the port of ``cost_volume_xla``: pad and
    81 static shifts in plain PyTorch, differentiated by autograd.
  * :class:`CostVolumeFunction` — the custom VJP of
    ``cost_volume_pallas``: the forward is the CUDA kernel K1, the
    backward the CUDA kernels K4a and K4b
    (``qpwcnet_torch.ops.cuda.cost_volume_kernel``); CPU tensors take
    :func:`cost_volume_plain` and the plain backward versions below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qpwcnet_torch.ops.activations import leaky_relu


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs (gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def _correlate(prv: torch.Tensor, pad_nxt: torch.Tensor,
               r: int) -> torch.Tensor:
    """The 81 shifted channel means of prv against nxt already padded to
    (B, H + 2r, W + 2r, C) in the compute dtype, leaky-ReLU'd, in prv's
    dtype."""
    d = 2 * r + 1
    _, h, w, c = prv.shape
    prv32 = prv.to(pad_nxt.dtype)
    inv_c = 1.0 / c
    costs = []
    for i0 in range(d):
        for j0 in range(d):
            roi = pad_nxt[:, i0:i0 + h, j0:j0 + w, :]
            costs.append(torch.sum(prv32 * roi, dim=-1) * inv_c)
    cvol = torch.stack(costs, dim=-1)
    return leaky_relu(cvol, 0.1).to(prv.dtype)


def cost_volume_plain(prv: torch.Tensor, nxt: torch.Tensor,
                      search_range: int = 4) -> torch.Tensor:
    """Plain formulation: zero-pad nxt by r, 81 shifted channel means.

    prv, nxt: (B, H, W, C) -> (B, H, W, (2r+1)**2) in prv's dtype.
    """
    r = search_range
    ct = _compute_dtype(prv)
    return _correlate(prv, F.pad(nxt.to(ct), (0, 0, r, r, r, r)), r)


def cost_volume_plain_haloed(prv: torch.Tensor, nxt_h: torch.Tensor,
                             search_range: int = 4) -> torch.Tensor:
    """:func:`cost_volume_plain` with the H halo supplied by the caller
    (port of ``cost_volume_xla_haloed``): ``nxt_h`` is (B, H + 2r, W, C),
    its rows [r, H + r) aligned to prv's, so only W is zero-padded (the
    spatial path exchanges the halo rows between H shards,
    qpwcnet_torch.parallel.spatial_ops)."""
    r = search_range
    _check_haloed(prv.shape, nxt_h, r)
    ct = _compute_dtype(prv)
    return _correlate(prv, F.pad(nxt_h.to(ct), (0, 0, r, r)), r)


def _check_haloed(prv_shape, nxt_h: torch.Tensor, r: int) -> None:
    b, h, w, c = prv_shape
    if tuple(nxt_h.shape) != (b, h + 2 * r, w, c):
        raise ValueError(f"haloed nxt must be {(b, h + 2 * r, w, c)}, got "
                         f"{tuple(nxt_h.shape)}")


def _search_range(dacc: torch.Tensor) -> int:
    d = int(round(dacc.shape[-1] ** 0.5))
    if d * d != dacc.shape[-1] or d % 2 == 0:
        raise ValueError(f"dacc has {dacc.shape[-1]} channels, not (2r+1)^2")
    return d // 2


def cost_volume_bwd_prv_plain(dacc: torch.Tensor, nxt: torch.Tensor,
                              nxt_h_haloed: bool = False) -> torch.Tensor:
    """d(cost)/d(prv) from the pre-activation gradient dacc (K4a's plain
    version, ``cost_volume_kernel.py:264-290``)::

        dprv[b,y,x,c] = (1/C) sum_k dacc[b,y,x,k] * nxt_pad[b,y+di,x+dj,c]

    dacc: (B, H, W, (2r+1)^2); nxt: (B, H, W, C), or (B, H + 2r, W, C)
    with its H halo supplied under ``nxt_h_haloed`` (only W is then
    zero-padded) -> (B, H, W, C) in nxt's dtype. Products and sums in
    float32 (float64 for float64).
    """
    r = _search_range(dacc)
    d = 2 * r + 1
    b, h, w, _ = dacc.shape
    c = nxt.shape[-1]
    ct = _compute_dtype(nxt)
    if nxt_h_haloed:
        _check_haloed((b, h, w, c), nxt, r)
    pad_h = 0 if nxt_h_haloed else r
    pad_nxt = F.pad(nxt.to(ct), (0, 0, r, r, pad_h, pad_h))
    dacc32 = dacc.to(ct)
    acc = torch.zeros((b, h, w, c), dtype=ct, device=nxt.device)
    for i in range(d):
        for j in range(d):
            roi = pad_nxt[:, i:i + h, j:j + w, :]
            acc += dacc32[..., i * d + j, None] * roi
    return (acc * (1.0 / c)).to(nxt.dtype)


def cost_volume_bwd_nxt_plain(dacc: torch.Tensor, prv: torch.Tensor,
                              h_haloed_out: bool = False) -> torch.Tensor:
    """d(cost)/d(nxt) from the pre-activation gradient dacc (K4b's plain
    version, ``cost_volume_kernel.py:293-328``), in gather form::

        dnxt[b,u,v,c] = (1/C) sum_k dacc[b,u-di,v-dj,k] * prv[b,u-di,v-dj,c]

    over source pixels (u-di, v-dj) inside the image. dacc: (B, H, W,
    (2r+1)^2); prv: (B, H, W, C) -> (B, H, W, C) in prv's dtype, or under
    ``h_haloed_out`` (B, H + 2r, W, C): rows u in [-r, H + r), the
    gradient of a haloed nxt (``cost_volume_kernel.py:392-399``: the
    operands are padded by 2r instead of r). Products and sums in float32
    (float64 for float64).
    """
    r = _search_range(dacc)
    d = 2 * r + 1
    b, h, w, c = prv.shape
    pad_h = 2 * r if h_haloed_out else r
    out_h = h + 2 * r if h_haloed_out else h
    pad = (0, 0, r, r, pad_h, pad_h)
    ct = _compute_dtype(prv)
    pad_prv = F.pad(prv.to(ct), pad)
    pad_dacc = F.pad(dacc.to(ct), pad)
    acc = torch.zeros((b, out_h, w, c), dtype=ct, device=prv.device)
    for i in range(d):
        for j in range(d):
            # source (u - di, v - dj) is row u + 2r - i of the padded maps
            si, sj = 2 * r - i, 2 * r - j
            acc += (pad_dacc[:, si:si + out_h, sj:sj + w, i * d + j, None]
                    * pad_prv[:, si:si + out_h, sj:sj + w, :])
    return (acc * (1.0 / c)).to(prv.dtype)


class CostVolumeFunction(torch.autograd.Function):
    """Cost volume with the custom VJP of ``cost_volume_pallas``
    (``cost_volume_kernel.py:152-213``).

    Forward: K1 on CUDA tensors, :func:`cost_volume_plain` on CPU ones;
    it saves (prv, nxt, out). Backward: dacc = g * (out > 0 ? 1 : 0.1) in
    g's dtype, then dprv by K4a and dnxt by K4b on CUDA tensors, or their
    plain versions on CPU ones.

    nxt_h_haloed: nxt is (B, H + 2r, W, C) with its H halo supplied by
    the caller (the kernels' haloed modes, or
    :func:`cost_volume_plain_haloed` on CPU), and d(nxt) comes back in
    that shape, the halo rows' gradient included.
    """

    @staticmethod
    def forward(ctx, prv, nxt, search_range=4, nxt_h_haloed=False):
        from qpwcnet_torch.ops.cuda import cost_volume_kernel as k

        fwd = k.cost_volume_haloed_cuda if nxt_h_haloed else \
            k.cost_volume_cuda
        out = fwd(prv, nxt, search_range=search_range)
        ctx.haloed = nxt_h_haloed
        ctx.save_for_backward(prv, nxt, out)
        return out

    @staticmethod
    def backward(ctx, g):
        from qpwcnet_torch.ops.cuda import cost_volume_kernel as k

        prv, nxt, out = ctx.saved_tensors
        # the leaky-relu derivative from the saved output's sign
        dacc = (g * torch.where(out > 0, 1.0, 0.1).to(g.dtype)).contiguous()
        bwd_prv, bwd_nxt = (
            (k.cost_volume_bwd_prv_haloed_cuda,
             k.cost_volume_bwd_nxt_haloed_cuda) if ctx.haloed else
            (k.cost_volume_bwd_prv_cuda, k.cost_volume_bwd_nxt_cuda))
        dprv = dnxt = None
        if ctx.needs_input_grad[0]:
            dprv = bwd_prv(dacc, nxt).to(prv.dtype)
        if ctx.needs_input_grad[1]:
            dnxt = bwd_nxt(dacc, prv).to(nxt.dtype)
        return dprv, dnxt, None, None


def cost_volume(prv: torch.Tensor, nxt: torch.Tensor, search_range: int = 4,
                impl: str = "auto", nxt_h_haloed: bool = False
                ) -> torch.Tensor:
    """Cost volume with implementation dispatch.

    impl: 'auto' runs :class:`CostVolumeFunction` (the CUDA kernels K1,
    K4a, K4b on CUDA tensors, their plain versions on CPU tensors);
    'plain' runs :func:`cost_volume_plain` (or
    :func:`cost_volume_plain_haloed`) on any device. 'fused' selects the
    fused warp+correlate kernel at the warp sites
    (models.blocks.UpFlowBlock); warp-free cost volumes under it are
    'auto'. nxt_h_haloed: nxt is (B, H + 2r, W, C), its H halo supplied
    by the caller (see :class:`CostVolumeFunction`).
    """
    if impl in ("auto", "fused"):
        return CostVolumeFunction.apply(prv, nxt, search_range, nxt_h_haloed)
    if impl == "plain":
        plain = cost_volume_plain_haloed if nxt_h_haloed else \
            cost_volume_plain
        return plain(prv, nxt, search_range=search_range)
    raise ValueError(f"unknown cost_volume impl: {impl!r}")
