"""The plain PyTorch versions of the port's CUDA kernels against the JAX
package, and the CPU dispatch rule of the kernel wrappers.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py compare each with its plain version there); here each
plain version is held against the JAX function its kernel replaces:

  * K1 ``cost_volume_plain`` vs ``cost_volume_pallas(interpret=True)``
    (and vs ``cost_volume_xla`` in tests/test_torch_ops.py);
  * K2 ``downconv_stage_plain`` vs ``downconv_stage_pallas(interpret=True)``
    and ``DownConv.apply``;
  * K3 ``warp_cost_volume_plain`` vs ``warp_cost_volume_pallas(
    interpret=True)`` and vs ``cost_volume_xla(prv, backward_warp(nxt,
    clip(flow, ±ww)))``, the identity of ``warp_cv_kernel.py:27-31``, and
    vs the warped window and banded products that its bf16 CUDA body
    computes (``csrc/warp_cv.cu``);
  * K4a ``cost_volume_bwd_prv_plain`` and K4b ``cost_volume_bwd_nxt_plain``
    vs ``_cv_bwd_prv_impl`` / ``_cv_bwd_nxt_impl(interpret=True)``, and
    both vs the banded products that their bf16 CUDA body computes
    (``csrc/cost_volume_bwd.cu``).

Also: the CPU dispatch rule of the wrappers, and the profiler's category
of each kernel's device name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qpwcnet_tpu.models.blocks import DownConv
from qpwcnet_tpu.ops.cost_volume import cost_volume_xla
from qpwcnet_tpu.ops.pallas.cost_volume_kernel import (
    _cv_bwd_nxt_impl,
    _cv_bwd_prv_impl,
    cost_volume_pallas,
)
from qpwcnet_tpu.ops.pallas.stem_kernel import downconv_stage_pallas
from qpwcnet_tpu.ops.pallas.warp_cv_kernel import warp_cost_volume_pallas
from qpwcnet_tpu.ops.warp import backward_warp
from qpwcnet_torch.models import build_flow_net
from qpwcnet_torch.ops import cuda as kernels
from qpwcnet_torch.ops.cost_volume import (
    cost_volume_bwd_nxt_plain,
    cost_volume_bwd_prv_plain,
    cost_volume_plain,
)
from qpwcnet_torch.ops.cuda.stem_kernel import (
    downconv_stage_cuda,
    downconv_stage_plain,
)
from qpwcnet_torch.ops.cuda.cost_volume_kernel import cost_volume_cuda
from qpwcnet_torch.ops.cuda.upconv_kernel import (
    upconv_stage_cuda,
    upconv_stage_plain,
)
from qpwcnet_torch.ops.cuda.warp_cv_kernel import (
    FUSED_WARP_WINDOW,
    warp_cost_volume_cuda,
    warp_cost_volume_plain,
)
from qpwcnet_torch.utils.profiling import category

BF16_ROUNDOFF = 2.0 ** -8  # half a bf16 ulp, relative


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _max_err(got, want):
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32))))


def _stage(h, w, cin, cout, seed):
    """A Flax DownConv with random (non-zero) biases, its input, and the
    same parameters as the port's [(OIHW weight, bias)] list."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    m = DownConv(cout, use_normalizer=False, dtype=jnp.float32)
    v = jax.device_get(m.init(jax.random.key(seed), jnp.asarray(x)))
    for name in ("conv_a", "conv_aa", "conv_b"):
        v["params"][name]["bias"] = (
            0.1 * rng.randn(cout)).astype(np.float32)
    params = [(_t(v["params"][n]["kernel"].transpose(3, 2, 0, 1)),
               _t(v["params"][n]["bias"]))
              for n in ("conv_a", "conv_aa", "conv_b")]
    return m, v, x, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 8, 16, 32), (2, 9, 37, 20)])
def test_cost_volume_plain_matches_pallas_kernel(shape, dtype):
    """K1's plain version against the TPU kernel itself. The kernel
    rounds each product prv * roi to the input dtype before its float32
    sum; the plain version (and the card's bf16 body) sums exact products.
    float32: sums in another order, 1e-6 of the magnitude; bf16: one bf16
    ulp (the rounded products differ by about a sixteenth of one)."""
    rng = np.random.RandomState(sum(shape))
    prv, nxt = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = cost_volume_plain(_t(prv, tdt), _t(nxt, tdt))
    want = cost_volume_pallas(jnp.asarray(prv).astype(jdt),
                              jnp.asarray(nxt).astype(jdt), interpret=True)
    assert got.shape == shape[:3] + (81,) and got.dtype == tdt
    assert want.dtype == jdt
    rel = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert _max_err(got, want) <= rel * max(1.0, float(np.max(np.abs(want))))


# K4a and K4b: each plain version, the TPU kernel that it replaces and
# the source map it reads (nxt for K4a, prv for K4b)
BWD = {"prv": (cost_volume_bwd_prv_plain, _cv_bwd_prv_impl),
       "nxt": (cost_volume_bwd_nxt_plain, _cv_bwd_nxt_impl)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 8, 16, 8), (2, 9, 37, 20)])
@pytest.mark.parametrize("grad", ["prv", "nxt"])
def test_cost_volume_bwd_plain_matches_pallas_kernel(grad, shape, dtype):
    """K4a's and K4b's plain versions against the TPU kernels themselves
    (cast from their float32 output to the input dtype). The kernels round
    each product to the input dtype before their float32 sum; the plain
    versions (and the card's bf16 body) sum exact products. float32: sums
    in another order, 1e-6 of the magnitude; bf16: one bf16 ulp."""
    rng = np.random.RandomState(sum(shape) + len(grad))
    dacc = rng.standard_normal(shape[:3] + (81,)).astype(np.float32)
    src = rng.standard_normal(shape).astype(np.float32)
    plain, impl = BWD[grad]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = plain(_t(dacc, tdt), _t(src, tdt))
    want = impl(jnp.asarray(dacc).astype(jdt), jnp.asarray(src).astype(jdt),
                interpret=True).astype(jdt)
    assert got.shape == shape and got.dtype == tdt
    rel = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert _max_err(got, want) <= rel * max(1.0, float(np.max(np.abs(want))))


def _banded_bwd(dacc, src, reversed_):
    """K4a (reversed_ False) or K4b (True) as the bf16 CUDA body computes
    them: for each displacement row i = di + 4 and each group of 8 output
    pixels x0..x0+7 of a row, the product of the zero-padded 16-column
    window A[c][q] = src[y ± di, x0 - 4 + q, c] with the band B[q][p],
    zero off 0 <= q - p <= 8:
      K4a  B[q][p] = dacc[y, x0 + p, 9i + (q - p)]             (output pixel)
      K4b  B[q][p] = dacc[y - di, x0 - 4 + q, 9i + 8 - (q - p)] (window pixel)
    summed over i and scaled by 1/C. float32 in, float32 out."""
    b, h, w, c = src.shape
    wp = -(-w // 8) * 8
    pad = (0, 0, 4, wp - w + 4, 4, 4)  # 4 rows, 4 columns left, to wp + 8
    psrc, pdacc = F.pad(src, pad), F.pad(dacc, pad)
    q = torch.arange(16)[:, None]
    p = torch.arange(8)[None, :]
    jj = q - p
    in_band = (jj >= 0) & (jj <= 8)
    out = torch.zeros(b, h, wp, c)
    for i in range(9):
        # padded row of the window (and, for K4b, of dacc): y + di + 4 or
        # y - di + 4, di = i - 4
        rows = torch.arange(h) + (8 - i if reversed_ else i)
        for x0 in range(0, wp, 8):
            a = psrc[:, rows, x0:x0 + 16, :]                  # (b, h, 16, c)
            if reversed_:
                k = 9 * i + 8 - jj.clamp(0, 8)
                band = pdacc[:, rows][:, :, x0 + q, k]        # (b, h, 16, 8)
            else:
                k = 9 * i + jj.clamp(0, 8)
                band = pdacc[:, 4:4 + h][:, :, x0 + 4 + p, k]
            band = band * in_band
            out[:, :, x0:x0 + 8, :] += torch.matmul(
                a.transpose(-1, -2), band).transpose(-1, -2)
    return out[:, :, :w] * (1.0 / c)


@pytest.mark.parametrize("grad", ["prv", "nxt"])
def test_cost_volume_bwd_band_decomposition(grad):
    """The index algebra of the bf16 CUDA body (K4b: the reversed offset,
    dacc read at the window pixel) against the plain versions, float32,
    on a map with W not a multiple of 8 and a border on every side."""
    rng = np.random.RandomState(12)
    shape = (2, 9, 21, 12)
    dacc = _t(rng.standard_normal(shape[:3] + (81,)))
    src = _t(rng.standard_normal(shape))
    got = _banded_bwd(dacc, src, reversed_=grad == "nxt")
    want = BWD[grad][0](dacc, src)
    assert got.shape == want.shape
    assert _max_err(got, want.numpy()) <= 1e-6 * max(
        1.0, float(want.abs().max()))


# Each kernel's device name as torch.profiler reports it (the demangled
# symbol) and its id in the profiler's breakdown.
KERNEL_NAMES = [
    ("void qpw::correlate_kernel<float, false>(float const*, float const*, "
     "float const*, float*, int, int, int, float)", "K1"),
    ("void qpw::cost_volume_mma_kernel<8, 1>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, int, "
     "int)", "K1"),
    ("void qpw::cost_volume_mma_kernel<2, 9>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, int, "
     "int)", "K1"),
    ("void qpw::stem_kernel<32>(float const*, float const*, float const*, "
     "float const*, float const*, float const*, float const*, float*, int, "
     "int, int)", "K2"),
    ("void qpw::stem_mma_kernel<16, true>(__nv_bfloat16 const*, float "
     "const*, float const*, float const*, float const*, float const*, float "
     "const*, __nv_bfloat16*, int, int, int, int, int, int, int, int)", "K2"),
    ("void qpw::correlate_kernel<__nv_bfloat16, true>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, int, "
     "float)", "K3"),
    ("void qpw::correlate_kernel<float, true>(float const*, float const*, "
     "float const*, float*, int, int, int, float)", "K3"),
    ("void qpw::warp_cv_mma_kernel<8, 1>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, int, "
     "float, int)", "K3"),
    ("void qpw::warp_cv_mma_kernel<4, 3>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, int, "
     "float, int)", "K3"),
    ("void qpw::warp_cv_mma_kernel<2, 9>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, int, "
     "float, int)", "K3"),
    ("void qpw::cv_bwd_kernel<float, false>(float const*, float const*, "
     "float*, int, int, int, int)", "K4a"),
    ("void qpw::cv_bwd_kernel<float, true>(float const*, float const*, "
     "float*, int, int, int, int)", "K4b"),
    ("void qpw::cv_bwd_mma_kernel<false, 8>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, int)",
     "K4a"),
    ("void qpw::cv_bwd_mma_kernel<false, 2>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, int)",
     "K4a"),
    ("void qpw::cv_bwd_mma_kernel<true, 4>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, int)",
     "K4b"),
    ("void qpw::upconv_kernel<16>(float const*, float const*, float const*, "
     "float*, int, int, int)", "K5"),
    ("void qpw::upconv_mma_kernel<32, 4>(__nv_bfloat16 const*, float const*, "
     "float const*, __nv_bfloat16*, int, int, int, int, int, int, int, int)",
     "K5"),
]


@pytest.mark.parametrize("name,kernel", KERNEL_NAMES)
def test_profiler_category_of_each_kernel(name, kernel):
    assert category(name) == kernel


@pytest.mark.parametrize("h,w,cin,cout", [(16, 24, 3, 16), (12, 20, 16, 32)])
def test_downconv_stage_plain_matches_jax(h, w, cin, cout):
    m, v, x, params = _stage(h, w, cin, cout, seed=h + cin)
    got = downconv_stage_plain(_t(x), params, torch.float32)
    ref_pallas = downconv_stage_pallas(jnp.asarray(x), v["params"],
                                       dtype=jnp.float32, tile_rows=8,
                                       interpret=True)
    ref_module = m.apply(v, jnp.asarray(x))
    assert got.shape == (2, h // 2, w // 2, cout)
    # three f32 convs summed in another order: 1e-5 of the magnitude
    tol = 1e-5 * max(1.0, float(np.max(np.abs(ref_module))))
    assert _max_err(got, ref_pallas) <= tol
    assert _max_err(got, ref_module) <= tol


def test_downconv_stage_plain_matches_jax_bf16():
    m, v, x, params = _stage(16, 24, 3, 16, seed=5)
    got = downconv_stage_plain(_t(x), params, torch.bfloat16)
    mb = DownConv(16, use_normalizer=False, dtype=jnp.bfloat16)
    want = mb.apply(v, jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    # bf16 convs, bias adds and Mish at the same rounding points; a
    # rounding flip in an early conv propagates through the later two
    tol = 4 * BF16_ROUNDOFF * max(1.0, float(np.max(np.abs(want))))
    assert _max_err(got, want) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_cost_volume_plain_matches_jax_composition(dtype):
    """Flows up to ±7 px exceed the ±4 window, so the clamp matters."""
    rng = np.random.RandomState(7)
    prv = rng.standard_normal((2, 10, 14, 8))
    nxt = rng.standard_normal((2, 10, 14, 8))
    flow = rng.uniform(-7, 7, (2, 10, 14, 2)).astype(np.float32)
    assert np.mean(np.abs(flow) > FUSED_WARP_WINDOW) > 0.2
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = warp_cost_volume_plain(_t(prv, tdt), _t(nxt, tdt), _t(flow))
    ww = float(FUSED_WARP_WINDOW)
    want = cost_volume_xla(
        jnp.asarray(prv, jdt),
        backward_warp(jnp.asarray(nxt, jdt),
                      jnp.clip(jnp.asarray(flow), -ww, ww)))
    assert got.shape == (2, 10, 14, 81) and got.dtype == tdt
    # warp + f32 channel sums; bf16: the warp's per-op rounding then the
    # output rounding
    rel = 1e-5 if dtype == "float32" else 2 * BF16_ROUNDOFF
    assert _max_err(got, want) <= rel * max(1.0, float(np.max(np.abs(want))))
    # and the clamp is not vacuous: the unclamped composition differs
    free = cost_volume_xla(jnp.asarray(prv, jdt),
                           backward_warp(jnp.asarray(nxt, jdt),
                                         jnp.asarray(flow)))
    assert _max_err(got, free) > 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_cost_volume_plain_matches_pallas_kernel(dtype):
    """K3's plain version against the TPU kernel itself, flows up to ±8 px
    so that the ±4 clamp matters. float32: 1e-6 of the magnitude. bf16:
    two ulps: the TPU kernel rounds the weight products and each
    correlation product to bf16, the plain version rounds at the lerp's
    operations and sums exact products."""
    rng = np.random.RandomState(40)
    shape = (1, 16, 24, 4)
    prv, nxt = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
    flow = rng.uniform(-8, 8, shape[:3] + (2,)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = warp_cost_volume_plain(_t(prv, tdt), _t(nxt, tdt), _t(flow),
                                 warp_window=4)
    want = warp_cost_volume_pallas(
        jnp.asarray(prv).astype(jdt), jnp.asarray(nxt).astype(jdt),
        jnp.asarray(flow), warp_window=4, interpret=True)
    assert got.shape == shape[:3] + (81,) and got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    rel = 1e-6 if dtype == "float32" else 2.0 ** -6
    assert _max_err(got, want) <= rel * max(1.0, float(np.max(np.abs(want))))


def _warped_window(nxt, flow, y0, x0, ww, zero_outside=True):
    """The (8+8) x 24 window of the 8 x 16 tile at (y0, x0) as the bf16 CUDA
    body of K3 stages it: each window pixel (gy, gx) warped by flow[gy, gx]
    clamped to ±ww, a bilinear sample of nxt with the corner origin
    clamped to [0, size-2] and the weights to [0, 1]; window pixels
    outside the image zero (``zero_outside``) or, as a wrong alternative,
    border-clamped. float32."""
    b, h, w, _ = nxt.shape
    gy = torch.arange(y0 - 4, y0 + 12)[:, None].expand(16, 24)
    gx = torch.arange(x0 - 4, x0 + 20)[None, :].expand(16, 24)
    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    f = flow[:, gy.clamp(0, h - 1), gx.clamp(0, w - 1)].clamp(-ww, ww)
    qx, qy = gx + f[..., 0], gy + f[..., 1]
    cx = torch.floor(qx).clamp(0, w - 2)
    cy = torch.floor(qy).clamp(0, h - 2)
    ax = (qx - cx).clamp(0, 1)[..., None]
    ay = (qy - cy).clamp(0, 1)[..., None]
    bi = torch.arange(b)[:, None, None]
    ix, iy = cx.long(), cy.long()

    def g(dy, dx):
        return nxt[bi, iy + dy, ix + dx]

    top = g(0, 0) + (g(0, 1) - g(0, 0)) * ax
    bot = g(1, 0) + (g(1, 1) - g(1, 0)) * ax
    win = top + (bot - top) * ay
    return win * inside[..., None] if zero_outside else win


def _banded_wcv(prv, nxt, flow, ww, zero_outside=True):
    """K3 as the bf16 CUDA body computes it: per 8 x 16 tile the warped
    window (:func:`_warped_window`), then K1's band: for output row y,
    displacement row i = di + 4 and 8 pixels x0 + 8j .. + 7, the product
    D = A B of the 16 window columns A[q][c] = win[y - y0 + i, 8j + q, c]
    and the pixels B[c][p] = prv[y, x0 + 8j + p, c], of which the band
    k = 9i + (q - p), 0 <= q - p <= 8, is kept; scaled by 1/C and
    leaky-ReLU'd. float32 in, float32 out."""
    b, h, w, c = prv.shape
    hp, wp = -(-h // 8) * 8, -(-w // 16) * 16
    pprv = F.pad(prv, (0, 0, 0, wp - w, 0, hp - h))
    out = torch.zeros(b, hp, wp, 81)
    p = torch.arange(8)[:, None]
    q = p + torch.arange(9)[None, :]  # (pixel, dj) -> window column
    for y0 in range(0, h, 8):
        for x0 in range(0, w, 16):
            win = _warped_window(nxt, flow, y0, x0, ww, zero_outside)
            for r in range(8):
                for i in range(9):
                    for j in range(2):
                        a = win[:, r + i, 8 * j:8 * j + 16]       # (b, 16, c)
                        x = x0 + 8 * j
                        bb = pprv[:, y0 + r, x:x + 8]            # (b, 8, c)
                        d = torch.matmul(a, bb.transpose(1, 2))  # (b, 16, 8)
                        out[:, y0 + r, x:x + 8, 9 * i:9 * i + 9] = d[:, q, p]
    return F.leaky_relu(out[:, :h, :w] * (1.0 / c), 0.1)


def test_warp_cost_volume_window_decomposition():
    """The window algebra of the bf16 CUDA body against the plain version,
    float32, with flows up to ±7 px and a border on every side: each
    window pixel warped by the flow at that pixel, zeros outside the
    image. Border-clamping the window instead would be wrong."""
    rng = np.random.RandomState(41)
    shape = (2, 9, 21, 12)
    prv, nxt = (_t(rng.standard_normal(shape)) for _ in range(2))
    flow = _t(rng.uniform(-7, 7, shape[:3] + (2,)))
    want = warp_cost_volume_plain(prv, nxt, flow, warp_window=4)
    tol = 1e-6 * max(1.0, float(want.abs().max()))
    got = _banded_wcv(prv, nxt, flow, 4.0)
    assert got.shape == want.shape
    assert _max_err(got, want.numpy()) <= tol
    clamped = _banded_wcv(prv, nxt, flow, 4.0, zero_outside=False)
    assert _max_err(clamped, want.numpy()) > 1e3 * tol


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor takes the plain version and counts no launch."""
    kernels.reset_launch_counts()
    rng = np.random.RandomState(3)
    prv = _t(rng.standard_normal((1, 8, 12, 16)))
    nxt = _t(rng.standard_normal((1, 8, 12, 16)))
    flow = _t(rng.uniform(-6, 6, (1, 8, 12, 2)))
    assert torch.equal(cost_volume_cuda(prv, nxt),
                       cost_volume_plain(prv, nxt))
    assert torch.equal(warp_cost_volume_cuda(prv, nxt, flow),
                       warp_cost_volume_plain(prv, nxt, flow))
    _, _, x, params = _stage(8, 12, 3, 16, seed=1)
    assert torch.equal(downconv_stage_cuda(_t(x), params, torch.float32),
                       downconv_stage_plain(_t(x), params, torch.float32))
    up = (_t(rng.standard_normal((1, 4, 6, 8))),
          _t(rng.standard_normal((8, 16, 4, 4))), _t(rng.standard_normal(16)))
    assert torch.equal(upconv_stage_cuda(*up, torch.float32),
                       upconv_stage_plain(*up, torch.float32))
    model = build_flow_net(0, "cpu", cv_impl="fast", stem_stages=2,
                           upconv_stages=2, head_scale="unit").train()
    outs = model(_t(rng.uniform(-0.5, 0.5, (1, 64, 64, 6))),
                 multiscale=True)
    sum(o.square().mean() for o in outs[:-1]).backward()
    assert kernels.launch_counts() == {
        "cost_volume_cuda": 0, "downconv_stage_cuda": 0,
        "warp_cost_volume_cuda": 0, "cost_volume_bwd_prv_cuda": 0,
        "cost_volume_bwd_nxt_cuda": 0, "upconv_stage_cuda": 0}


def test_stem_rejects_odd_sizes():
    _, _, x, params = _stage(8, 12, 3, 16, seed=2)
    with pytest.raises(ValueError):
        downconv_stage_cuda(_t(x)[:, :7], params, torch.float32)
    # stem_stages=2 needs H, W divisible by 4: stage 1 sees 3x5 here
    model = build_flow_net(0, "cpu", stem_stages=2)
    with pytest.raises(ValueError), torch.no_grad():
        model(torch.zeros(1, 6, 10, 6))
