from qpwcnet_torch.data.augment import (
    apply_flow_augmentation,
    apply_triplet_augmentation,
    augment_triplet_batch,
    draw_flow_augmentation,
    draw_triplet_augmentation,
    image_augment_batch,
    photometric_augmentation,
    rotation_matrix_from_euler,
)
from qpwcnet_torch.data.fchairs3d import decode_pair, read_set_file
from qpwcnet_torch.data.pfm import read_pfm
from qpwcnet_torch.data.pipeline import (
    PrefetchLoader,
    load_image,
    prefetch_iterator,
    preprocess_flow_batch,
    preprocess_triplet_batch,
    triplet_sample_fn,
)
from qpwcnet_torch.data.synthetic import (
    random_flow_field,
    random_texture,
    synthetic_flow_batch,
    synthetic_triplet_batch,
    zero_baseline_epe,
)
from qpwcnet_torch.data.triplet import (
    DummyTripletDataset,
    TripletDataset,
    VimeoTriplet,
    YoutubeVos,
)

__all__ = [
    "apply_flow_augmentation",
    "apply_triplet_augmentation",
    "augment_triplet_batch",
    "draw_flow_augmentation",
    "draw_triplet_augmentation",
    "image_augment_batch",
    "photometric_augmentation",
    "rotation_matrix_from_euler",
    "decode_pair",
    "read_set_file",
    "read_pfm",
    "PrefetchLoader",
    "load_image",
    "prefetch_iterator",
    "preprocess_flow_batch",
    "preprocess_triplet_batch",
    "triplet_sample_fn",
    "random_flow_field",
    "random_texture",
    "synthetic_flow_batch",
    "synthetic_triplet_batch",
    "zero_baseline_epe",
    "DummyTripletDataset",
    "TripletDataset",
    "VimeoTriplet",
    "YoutubeVos",
]
