"""The PyTorch port's flow augmentation and flow-batch preprocessing
(qpwcnet_torch/data/augment.py, ops/resize.py:scale_and_translate_bilinear,
data/pipeline.py:preprocess_flow_batch) against the JAX package's on CPU.

The JAX functions draw from a key; the tests remake those draws with
JAX's own splits (``split(key, B)``; per sample ``k1..k4 = split(k, 4)``,
``ks, ky, kx = split(k3, 3)``, ``kb, ks, kh, kc = split(k4, 4)``) and
feed them to the port's deterministic part. Tolerances: images within
1e-5, flows within 1e-4 px of JAX run op by op (float32 rounding of the
two-tap resampling and the HSV round trips). Under ``jax.jit`` XLA
contracts the sample position's multiply and subtract into one fused
multiply-add, which moves a sample by up to an ulp of its coordinate and
the jitted JAX function from its own op-by-op result by up to 3e-6 at one
resampling (measured); against the jitted functions
(``image_augment_batch``, ``preprocess_flow_batch``) images are held
within 5e-5 and flows within 5e-4 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_tpu.data import augment as J
from qpwcnet_tpu.data.pipeline import preprocess_flow_batch as j_preprocess
from qpwcnet_torch.data import augment as P
from qpwcnet_torch.data.pipeline import preprocess_flow_batch
from qpwcnet_torch.ops.resize import scale_and_translate_bilinear
from tests.test_torch_model import one_torch_thread  # noqa: F401

IMS_TOL, FLO_TOL = 1e-5, 1e-4
JIT_IMS_TOL, JIT_FLO_TOL = 5e-5, 5e-4


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_flow_draws(key, b: int, base_scale: float = 1.0) -> dict:
    """image_augment_batch's draws from ``key``, in the port's layout."""
    out = {k: [] for k in ("flip_ud", "flip_lr", "scale", "oy_frac",
                           "ox_frac", "brightness", "saturation", "hue",
                           "contrast")}
    for k in jax.random.split(key, b):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        ks, ky, kx = jax.random.split(k3, 3)
        kb, kso, kh, kc = jax.random.split(k4, 4)
        u = jax.random.uniform
        vals = {
            "flip_ud": u(k1, ()) < 0.5, "flip_lr": u(k2, ()) < 0.5,
            "scale": u(ks, (), minval=base_scale * 0.955,
                       maxval=base_scale * 1.05),
            "oy_frac": u(ky, ()), "ox_frac": u(kx, ()),
            "brightness": u(kb, (), minval=-0.125, maxval=0.125),
            "saturation": u(kso, (), minval=0.5, maxval=1.5),
            "hue": u(kh, (), minval=-0.2, maxval=0.2),
            "contrast": u(kc, (), minval=0.5, maxval=1.5),
        }
        for name, v in vals.items():
            out[name].append(np.asarray(v))
    return {k: _t(np.stack(v)) for k, v in out.items()}


def _pixels(seed, shape=(2, 8, 12, 3)):
    """Random RGB in [0, 1] with grey, black and white pixels, and pixels
    whose hue is negative before the wrap (max r, g < b)."""
    x = np.random.RandomState(seed).uniform(0, 1, shape).astype(np.float32)
    x[0, 0, :4] = [[0.3] * 3, [0.0] * 3, [1.0] * 3, [0.7] * 3]
    x[0, 1, :2] = [[0.9, 0.1, 0.5], [0.6, 0.2, 0.59]]
    return x


# ------------------------------------------------------------ color space

def test_rgb_to_hsv_matches_jax():
    x = _pixels(0)
    got = P.rgb_to_hsv(_t(x))
    want = np.asarray(J.rgb_to_hsv(jnp.asarray(x)))
    assert _err(got, want) <= 1e-6
    # grey and black pixels: hue 0, saturation 0; the wrap is a floor-mod
    assert got[0, 0, :4, :2].abs().max() == 0
    assert 0.8 < float(got[0, 1, 0, 0]) < 1.0


@pytest.mark.parametrize("fn, arg", [
    ("adjust_brightness", -0.1), ("adjust_saturation", 1.4),
    ("adjust_saturation", 0.3), ("adjust_hue", 0.17), ("adjust_hue", -0.2),
    ("adjust_contrast", 0.6)])
def test_adjust_matches_jax(fn, arg):
    """Inputs a little outside [0, 1] too (the clips before HSV)."""
    x = _pixels(1) * 1.2 - 0.1
    got = getattr(P, fn)(_t(x), arg)
    want = getattr(J, fn)(jnp.asarray(x), arg)
    assert _err(got, want) <= IMS_TOL


# -------------------------------------------------------------- flow pair

def _pair(seed, b=4, h=24, w=40):
    rng = np.random.RandomState(seed)
    ims = rng.uniform(0, 1, (b, h, w, 6)).astype(np.float32)
    flo = rng.uniform(-6, 6, (b, h, w, 2)).astype(np.float32)
    return ims, flo


def test_flips_match_jax():
    ims, flo = _pair(2, b=8)
    key = jax.random.key(3)
    for name in ("flip_ud_pair", "flip_lr_pair"):
        keys = jax.random.split(key, 8)
        want = [getattr(J, name)(k, jnp.asarray(i), jnp.asarray(f))
                for k, i, f in zip(keys, ims, flo)]
        flip = _t([bool(jax.random.uniform(k, ()) < 0.5) for k in keys])
        assert flip.any() and not flip.all()
        got = getattr(P, name)(_t(ims), _t(flo), flip)
        for g, w in zip(got, zip(*want)):
            assert torch.equal(g, _t(np.stack(w)))


def test_flips_folded_into_the_crop():
    """scale_and_crop with the flips folded into its indices and the
    flow's sign equals the explicit flips then scale_and_crop, bit for
    bit, also from uint8 frames."""
    ims, flo = _pair(3, b=8)
    draws = P.draw_flow_augmentation(torch.Generator().manual_seed(4), 8)
    assert draws["flip_ud"].any() and not draws["flip_ud"].all()
    crop = (draws["scale"], draws["oy_frac"], draws["ox_frac"])
    u8 = (_t(ims) * 255).round().to(torch.uint8)
    for frames in (_t(ims), u8):
        i, f = P.flip_ud_pair(frames, _t(flo), draws["flip_ud"])
        i, f = P.flip_lr_pair(i, f, draws["flip_lr"])
        want = P.scale_and_crop(i, f, (16, 32), *crop)
        got = P.scale_and_crop(frames, _t(flo), (16, 32), *crop,
                               draws["flip_ud"], draws["flip_lr"])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    as_float = P.scale_and_crop(u8.float() / 255, _t(flo), (16, 32), *crop)
    assert _err(P.scale_and_crop(u8, _t(flo), (16, 32), *crop)[0],
                as_float[0]) <= 1e-6


@pytest.mark.parametrize("in_hw, out_hw, base_scale", [
    ((24, 40), (16, 32), 1.0),     # a crop inside the scaled image
    ((24, 40), (24, 40), 1.0),     # s < 1 leaves rows past the image: 0
    ((48, 80), (24, 40), 0.56)])   # FlyingThings3D's base scale
def test_scale_and_crop_matches_jax(in_hw, out_hw, base_scale):
    ims, flo = _pair(4, h=in_hw[0], w=in_hw[1])
    key = jax.random.key(7)
    draws = jax_flow_draws(key, 4, base_scale)
    want = []
    for b, k in enumerate(jax.random.split(key, 4)):
        _, _, k3, _ = jax.random.split(k, 4)
        want.append(J.scale_and_crop(k3, jnp.asarray(ims[b]),
                                     jnp.asarray(flo[b]), out_hw,
                                     base_scale))
    got = P.scale_and_crop(_t(ims), _t(flo), out_hw, draws["scale"],
                           draws["oy_frac"], draws["ox_frac"])
    w_ims, w_flo = (np.stack([np.asarray(w[i]) for w in want])
                    for i in (0, 1))
    assert _err(got[0], w_ims) <= IMS_TOL
    assert _err(got[1], w_flo) <= FLO_TOL
    if out_hw == in_hw:  # a sample scaled below 1: its last row is past
        small = (draws["scale"] < 1).numpy()
        assert small.any()
        assert (w_ims[small, -1] == 0).all()
        assert (got[0][small, -1] == 0).all()


def test_scale_and_translate_matches_jax():
    """Per-sample scales up and down, fractional translations, and a NaN
    and an inf, which spread through the channel as JAX's einsum does."""
    x = np.random.RandomState(5).uniform(-3, 3, (3, 20, 36, 5)).astype(
        np.float32)
    x[1, 3, 5, 2] = np.nan
    x[2, 4, 5, 1] = np.inf
    scale = np.array([0.955 * 0.56, 1.0, 1.4], np.float32)
    trans = np.array([[-2.3, -1.7], [0.0, 0.0], [-5.5, -10.25]], np.float32)
    for out_hw in ((16, 32), (30, 50)):
        want = np.stack([np.asarray(jax.image.scale_and_translate(
            jnp.asarray(x[b]), out_hw + (5,), (0, 1),
            jnp.asarray([scale[b]] * 2), jnp.asarray(trans[b]), "bilinear",
            antialias=False)) for b in range(3)])
        got = scale_and_translate_bilinear(_t(x), out_hw, _t(scale),
                                           _t(trans)).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert _err(got[fin], want[fin]) <= 1e-5 * 3
        assert np.array_equal(got == 0, want == 0)


def test_color_augment_pair_matches_jax():
    ims = np.concatenate([_pixels(6, (4, 8, 12, 3)),
                          _pixels(7, (4, 8, 12, 3))], -1)
    key = jax.random.key(9)
    keys = jax.random.split(key, 4)
    want = np.stack([np.asarray(J.color_augment_pair(k, jnp.asarray(i)))
                     for k, i in zip(keys, ims)])
    draws = {n: [] for n in ("brightness", "saturation", "hue", "contrast")}
    for k in keys:
        kb, ks, kh, kc = jax.random.split(k, 4)
        u = jax.random.uniform
        for n, v in (("brightness", u(kb, (), minval=-0.125, maxval=0.125)),
                     ("saturation", u(ks, (), minval=0.5, maxval=1.5)),
                     ("hue", u(kh, (), minval=-0.2, maxval=0.2)),
                     ("contrast", u(kc, (), minval=0.5, maxval=1.5))):
            draws[n].append(np.asarray(v))
    got = P.color_augment_pair(_t(ims), *(_t(np.stack(draws[n]))
                                          for n in draws))
    assert _err(got, want) <= IMS_TOL


@pytest.mark.parametrize("in_hw, out_hw, base_scale", [
    ((32, 64), (32, 64), 1.0), ((48, 80), (24, 40), 0.56)])
def test_image_augment_batch_matches_jax(in_hw, out_hw, base_scale):
    """Against JAX's per-sample image_augment op by op, and against its
    jitted, vmapped image_augment_batch."""
    ims, flo = _pair(10, b=6, h=in_hw[0], w=in_hw[1])
    key = jax.random.key(11)
    draws = jax_flow_draws(key, 6, base_scale)
    assert draws["flip_ud"].any() and draws["flip_lr"].any()
    g_ims, g_flo = P.apply_flow_augmentation(_t(ims), _t(flo), draws,
                                             out_hw)
    each = [J.image_augment(k, jnp.asarray(i), jnp.asarray(f), out_hw,
                            base_scale)
            for k, i, f in zip(jax.random.split(key, 6), ims, flo)]
    assert _err(g_ims, np.stack([e[0] for e in each])) <= IMS_TOL
    assert _err(g_flo, np.stack([e[1] for e in each])) <= FLO_TOL
    w_ims, w_flo = J.image_augment_batch(key, jnp.asarray(ims),
                                         jnp.asarray(flo), out_hw,
                                         base_scale)
    assert g_ims.shape == w_ims.shape and g_flo.shape == w_flo.shape
    assert _err(g_ims, w_ims) <= JIT_IMS_TOL
    assert _err(g_flo, w_flo) <= JIT_FLO_TOL


def test_flow_draws_on_the_generator():
    one = P.draw_flow_augmentation(torch.Generator().manual_seed(1), 64,
                                   0.56)
    two = P.draw_flow_augmentation(torch.Generator().manual_seed(1), 64,
                                   0.56)
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert one["flip_ud"].dtype == torch.bool
    s = one["scale"]
    assert float(s.min()) >= 0.56 * 0.955 and float(s.max()) <= 0.56 * 1.05
    assert float(one["hue"].abs().max()) <= 0.2
    assert 0 <= float(one["oy_frac"].min()) and float(
        one["ox_frac"].max()) < 1
    ims, flo = _pair(12, b=2)
    a = P.image_augment_batch(torch.Generator().manual_seed(3), _t(ims),
                              _t(flo), (16, 32))
    b = P.image_augment_batch(torch.Generator().manual_seed(3), _t(ims),
                              _t(flo), (16, 32))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------------ preprocess

@pytest.mark.parametrize("augment", [False, True])
def test_preprocess_flow_batch_matches_jax(augment):
    """uint8 frames and a flow with NaNs in one sample, both paths."""
    rng = np.random.RandomState(13)
    ims = rng.randint(0, 256, (3, 48, 80, 6)).astype(np.uint8)
    flo = rng.uniform(-8, 8, (3, 48, 80, 2)).astype(np.float32)
    flo[1, 10, 20, 0] = np.nan
    key = jax.random.key(14)
    want = j_preprocess(key, jnp.asarray(ims), jnp.asarray(flo),
                        out_hw=(24, 40), base_scale=0.56, augment=augment)
    draws = jax_flow_draws(key, 3, 0.56) if augment else None
    got = preprocess_flow_batch(_t(ims), _t(flo), (24, 40), draws=draws)
    assert _err(got["ims"], want["ims"]) <= JIT_IMS_TOL
    assert _err(got["flo"], want["flo"]) <= JIT_FLO_TOL
    assert bool(torch.isfinite(got["flo"]).all())


@pytest.mark.parametrize("augment, out_hw", [
    (False, (16, 32)), (False, (32, 32)), (True, (16, 32))])
def test_preprocess_nan_zeroes_the_channel_like_jax(augment, out_hw):
    """JAX's resampling contracts each resized axis with a dense weight
    matrix, so one NaN pixel of u makes u NaN along every resized axis,
    and the scrub then zeroes it: with both axes resized (and always under
    augmentation) the sample's whole u, with one axis its row. v and the
    other sample keep their values."""
    ims = np.zeros((2, 32, 64, 6), np.uint8)
    flo = np.full((2, 32, 64, 2), 1.5, np.float32)
    flo[0, 3, 5, 0] = np.nan
    key = jax.random.key(0)
    want = j_preprocess(key, jnp.asarray(ims), jnp.asarray(flo),
                        out_hw=out_hw, augment=augment)
    draws = jax_flow_draws(key, 2) if augment else None
    got = preprocess_flow_batch(_t(ims), _t(flo), out_hw, draws=draws)
    want_flo = np.asarray(want["flo"])
    assert _err(got["flo"], want_flo) <= JIT_FLO_TOL
    u = got["flo"][0, ..., 0]
    if out_hw == (32, 32):
        assert (u[3] == 0).all() and (u[4:] != 0).all()
    else:
        assert (u == 0).all() and (want_flo[0, ..., 0] == 0).all()
    assert (got["flo"][0, ..., 1] != 0).any()
    assert (got["flo"][1] != 0).all()
