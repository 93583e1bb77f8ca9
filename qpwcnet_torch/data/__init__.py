from qpwcnet_torch.data.augment import (
    apply_triplet_augmentation,
    augment_triplet_batch,
    draw_triplet_augmentation,
    photometric_augmentation,
    rotation_matrix_from_euler,
)
from qpwcnet_torch.data.pipeline import (
    preprocess_flow_batch,
    preprocess_triplet_batch,
)
from qpwcnet_torch.data.synthetic import (
    random_flow_field,
    random_texture,
    synthetic_flow_batch,
    synthetic_triplet_batch,
    zero_baseline_epe,
)

__all__ = [
    "apply_triplet_augmentation",
    "augment_triplet_batch",
    "draw_triplet_augmentation",
    "photometric_augmentation",
    "rotation_matrix_from_euler",
    "preprocess_flow_batch",
    "preprocess_triplet_batch",
    "random_flow_field",
    "random_texture",
    "synthetic_flow_batch",
    "synthetic_triplet_batch",
    "zero_baseline_epe",
]
