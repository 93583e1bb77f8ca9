"""Triplet-consistent augmentation of the pretraining batches, on the
batch's device (port of the triplet half of qpwcnet_tpu/data/augment.py).

Every draw comes from an explicit ``torch.Generator``
(:func:`draw_triplet_augmentation`); the deterministic part takes the
draws as arguments (:func:`apply_triplet_augmentation`), so a test can
feed both packages the same numbers. The JAX package draws from
``jax.random`` keys: the same seed gives other numbers, from the same
distributions.

Per sample, the same for the three frames: a random 3D rotation of the
RGB vectors, a log-space scale and an offset (photometric), gaussian
noise of sigma 0.02, and up-down and left-right flips. Images are float32
in [0, 1].
"""

from __future__ import annotations

import torch

from qpwcnet_torch.data.synthetic import _uniform


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
