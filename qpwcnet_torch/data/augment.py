"""Data augmentation on the batch's device (port of
qpwcnet_tpu/data/augment.py): the flow pairs' and the triplets'.

Every draw comes from an explicit ``torch.Generator``
(:func:`draw_flow_augmentation`, :func:`draw_triplet_augmentation`); the
deterministic part takes the draws as arguments
(:func:`apply_flow_augmentation`, :func:`apply_triplet_augmentation`), so
a test can feed both packages the same numbers. The JAX package draws
from ``jax.random`` keys: the same seed gives other numbers, from the
same distributions.

Flow pairs, per sample: an up-down and a left-right flip with the flow
component's sign fixed, a scale in base * [0.955, 1.05] and a crop to the
output size as one bilinear resampling (the flow scaled by the same
factor), then brightness, saturation, hue and contrast, the same for both
frames. Triplets, per sample and the same for the three frames: a random
3D rotation of the RGB vectors, a log-space scale and an offset
(photometric), gaussian noise of sigma 0.02, and up-down and left-right
flips. Images are float32 in [0, 1].
"""

from __future__ import annotations

import torch

from qpwcnet_torch.data.synthetic import _uniform
from qpwcnet_torch.ops.flow_vis import hsv_to_rgb
from qpwcnet_torch.ops.resize import scale_and_translate_bilinear


# ------------------------------------------------------------ color space

def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> HSV, channels in the last axis, all in [0, 1]; grey pixels
    (max == min) have hue 0, black ones saturation 0."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.amax(rgb, dim=-1)
    mn = torch.amin(rgb, dim=-1)
    diff = mx - mn
    safe = torch.where(diff > 0, diff, 1.0)
    # torch.remainder is floor-mod, JAX's %: a negative hue wraps to [0, 6)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(diff > 0, h / 6.0, 0.0)
    s = torch.where(mx > 0, diff / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def adjust_brightness(img: torch.Tensor, delta) -> torch.Tensor:
    return img + delta


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    """Saturation times factor, clipped to [0, 1] (img clipped first)."""
    hsv = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def adjust_hue(img: torch.Tensor, delta) -> torch.Tensor:
    """Hue plus delta, wrapped to [0, 1) (img clipped first)."""
    hsv = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """(img - mean) * factor + mean, the mean over H and W of each frame
    and channel of img (..., H, W, C); not clipped."""
    mean = torch.mean(img, dim=(-3, -2), keepdim=True)
    return (img - mean) * factor + mean


# -------------------------------------------------------------- flow pair

def _per_sample(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (B,) draw shaped to broadcast against a (B, ...) tensor of ndim
    dims."""
    return v.view((-1,) + (1,) * (ndim - 1))


def color_augment_pair(ims6: torch.Tensor, brightness: torch.Tensor,
                       saturation: torch.Tensor, hue: torch.Tensor,
                       contrast: torch.Tensor) -> torch.Tensor:
    """Brightness, saturation, hue and contrast with one (B,) draw each,
    the same for both frames of each pair. ims6: (B, H, W, 6)."""
    x = torch.stack([ims6[..., :3], ims6[..., 3:]], dim=1)  # (B,2,H,W,3)
    x = adjust_brightness(x, _per_sample(brightness, 5))
    x = adjust_saturation(x, _per_sample(saturation, 4))
    x = adjust_hue(x, _per_sample(hue, 4))
    x = adjust_contrast(x, _per_sample(contrast, 5))
    return torch.cat([x[:, 0], x[:, 1]], dim=-1)


def flip_ud_pair(ims6: torch.Tensor, flo: torch.Tensor, flip: torch.Tensor):
    """Up-down flip of the samples where the (B,) bool ``flip`` holds, the
    flow's v component negated."""
    ims_f = torch.flip(ims6, dims=(1,))
    flo_f = torch.flip(flo, dims=(1,)) * flo.new_tensor([1.0, -1.0])
    f = _per_sample(flip, 4)
    return torch.where(f, ims_f, ims6), torch.where(f, flo_f, flo)


def flip_lr_pair(ims6: torch.Tensor, flo: torch.Tensor, flip: torch.Tensor):
    """Left-right flip of the samples where ``flip`` holds, the flow's u
    component negated."""
    ims_f = torch.flip(ims6, dims=(2,))
    flo_f = torch.flip(flo, dims=(2,)) * flo.new_tensor([-1.0, 1.0])
    f = _per_sample(flip, 4)
    return torch.where(f, ims_f, ims6), torch.where(f, flo_f, flo)


def scale_and_crop(ims6: torch.Tensor, flo: torch.Tensor, out_hw,
                   scale: torch.Tensor, oy_frac: torch.Tensor,
                   ox_frac: torch.Tensor, flip_ud=None, flip_lr=None):
    """Scale each sample by its ``scale`` and crop out_hw at the offset
    (oy_frac, ox_frac) x the room the scaled image leaves (0 where it
    leaves none), as one bilinear resampling without antialias; the flow
    is scaled by the same factor. Where the scaled image is smaller than
    out_hw the crop reaches past it, and those outputs are 0.

    ``flip_ud`` / ``flip_lr`` (B,) bool: :func:`flip_ud_pair` /
    :func:`flip_lr_pair` first, folded into the resampling's indices and
    the flow's sign (the same values). ims6 may be uint8 (read as /255):
    it is gathered before the conversion."""
    h, w = ims6.shape[1], ims6.shape[2]
    oh, ow = out_hw
    oy = oy_frac * torch.clamp(h * scale - oh, min=0.0)
    ox = ox_frac * torch.clamp(w * scale - ow, min=0.0)
    args = ((oh, ow), scale, torch.stack([-oy, -ox], dim=-1), flip_ud,
            flip_lr)
    ims = scale_and_translate_bilinear(ims6, *args)
    flo = scale_and_translate_bilinear(flo, *args)
    sign = torch.ones(flo.shape[0], 2, device=flo.device)
    for c, flip in ((1, flip_ud), (0, flip_lr)):
        if flip is not None:
            sign[:, c] = torch.where(flip, -1.0, 1.0)
    return ims, flo * (sign * scale[:, None])[:, None, None, :]


def draw_flow_augmentation(gen: torch.Generator, b: int,
                           base_scale: float = 1.0) -> dict:
    """The random draws of :func:`image_augment_batch` for b samples on
    ``gen``'s device, each (B,): the bool 'flip_ud' and 'flip_lr'; 'scale'
    in base_scale * [0.955, 1.05]; the crop offsets 'oy_frac', 'ox_frac'
    as fractions of the room in [0, 1); 'brightness' in [-0.125, 0.125],
    'saturation' in [0.5, 1.5], 'hue' in [-0.2, 0.2], 'contrast' in [0.5,
    1.5]."""
    return {
        "flip_ud": _uniform(gen, (b,)) < 0.5,
        "flip_lr": _uniform(gen, (b,)) < 0.5,
        "scale": _uniform(gen, (b,), base_scale * 0.955, base_scale * 1.05),
        "oy_frac": _uniform(gen, (b,)),
        "ox_frac": _uniform(gen, (b,)),
        "brightness": _uniform(gen, (b,), -0.125, 0.125),
        "saturation": _uniform(gen, (b,), 0.5, 1.5),
        "hue": _uniform(gen, (b,), -0.2, 0.2),
        "contrast": _uniform(gen, (b,), 0.5, 1.5),
    }


def apply_flow_augmentation(ims6: torch.Tensor, flo: torch.Tensor,
                            draws: dict, out_hw):
    """The deterministic part of :func:`image_augment_batch`: flips, then
    scale and crop to out_hw (the flips folded into it), then colour, with
    ``draws`` (:func:`draw_flow_augmentation`'s layout; the JAX package's
    per-sample ``image_augment`` batched). ims6: (B, H, W, 6) float32 in
    [0, 1], or uint8 (read as /255); flo: (B, H, W, 2)."""
    ims6, flo = scale_and_crop(ims6, flo, tuple(out_hw), draws["scale"],
                               draws["oy_frac"], draws["ox_frac"],
                               draws["flip_ud"], draws["flip_lr"])
    ims6 = color_augment_pair(ims6, draws["brightness"],
                              draws["saturation"], draws["hue"],
                              draws["contrast"])
    return ims6, flo


def image_augment_batch(gen: torch.Generator, ims6: torch.Tensor,
                        flo: torch.Tensor, out_hw, base_scale: float = 1.0):
    """The flow-supervised augmentation of a batch, each sample with its
    own draws from ``gen``: flips, scale and crop, colour."""
    return apply_flow_augmentation(
        ims6, flo, draw_flow_augmentation(gen, ims6.shape[0], base_scale),
        out_hw)


# ---------------------------------------------------------------- triplet


def rotation_matrix_from_euler(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) euler angles -> (..., 3, 3) rotation matrices."""
    c, s = torch.cos(angles), torch.sin(angles)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    rows = torch.stack([
        cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz,
        cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz,
        -sy, sx * cy, cx * cy,
    ], dim=-1)
    return rows.reshape(rows.shape[:-1] + (3, 3))


def photometric_augmentation(x: torch.Tensor, z_txn: torch.Tensor,
                             z_rxn: torch.Tensor,
                             z_scale: torch.Tensor) -> torch.Tensor:
    """Rotate the RGB vectors of x (..., 3) by the euler angles z_rxn,
    then scale by z_scale and offset by z_txn (each (..., 3), broadcast
    against x's leading dims)."""
    rot = rotation_matrix_from_euler(z_rxn)
    y = (rot * x[..., None, :]).sum(dim=-1)
    return y * z_scale + z_txn


def draw_triplet_augmentation(gen: torch.Generator, b: int, h: int, w: int,
                              max_txn: float = 0.3, max_rxn: float = 0.3,
                              max_scale: float = 0.3) -> dict:
    """The random draws of :func:`augment_triplet_batch` for a batch of b
    (h, w) triplets, on ``gen``'s device: {'txn', 'rxn', 'scale'} (1, B,
    1, 1, 3) (scale already exponentiated), 'noise' (1, B, H, W, 3) and
    the boolean 'flip_ud', 'flip_lr' (1, B, 1, 1, 1)."""
    z = (1, b, 1, 1, 3)
    return {
        "txn": _uniform(gen, z, -max_txn, max_txn),
        "rxn": _uniform(gen, z, -max_rxn, max_rxn),
        "scale": torch.exp(_uniform(gen, z, -max_scale, max_scale)),
        "noise": torch.randn((1, b, h, w, 3), generator=gen,
                             device=gen.device),
        "flip_ud": _uniform(gen, (1, b, 1, 1, 1)) < 0.5,
        "flip_lr": _uniform(gen, (1, b, 1, 1, 1)) < 0.5,
    }


def apply_triplet_augmentation(a: torch.Tensor, b: torch.Tensor,
                               c: torch.Tensor, draws: dict):
    """The deterministic part of :func:`augment_triplet_batch`: the
    photometric transform, the noise (times 0.02) and the flips of
    ``draws`` applied identically to the three (B, H, W, 3) frames."""
    x = torch.stack([a, b, c], dim=0)  # (3, B, H, W, 3)
    y = photometric_augmentation(x, draws["txn"], draws["rxn"],
                                 draws["scale"])
    y = y + draws["noise"] * 0.02
    for flip, dim in ((draws["flip_ud"], 2), (draws["flip_lr"], 3)):
        y = torch.where(flip, torch.flip(y, dims=(dim,)), y)
    return y[0], y[1], y[2]


def augment_triplet_batch(gen: torch.Generator, a: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor):
    """Batched triplet-consistent augmentation: per-sample draws from
    ``gen``, the same for the three frames. a, b, c: (B, H, W, 3) float32
    in [0, 1]."""
    bsz, h, w, _ = a.shape
    return apply_triplet_augmentation(
        a, b, c, draw_triplet_augmentation(gen, bsz, h, w))
