from qpwcnet_torch.data.pipeline import preprocess_flow_batch
from qpwcnet_torch.data.synthetic import (
    random_flow_field,
    random_texture,
    synthetic_flow_batch,
    zero_baseline_epe,
)

__all__ = [
    "preprocess_flow_batch",
    "random_flow_field",
    "random_texture",
    "synthetic_flow_batch",
    "zero_baseline_epe",
]
