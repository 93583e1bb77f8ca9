"""Training metrics (port of qpwcnet_tpu/train/metrics.py): scalars to
``log/metrics.jsonl``, one record per call with its ``step`` and
``time``, and to TensorBoard through tensorboardX when it imports, with
the flow-RGB image summaries there."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from qpwcnet_torch.ops.flow_vis import flow_to_image


class MetricWriter:
    """Scalar and image summaries under ``log_dir``."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(str(self.log_dir))
        except ImportError:
            self._tb = None

    def scalars(self, step: int, values: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, rec[k], int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def flow_image(self, step: int, tag: str, flow) -> None:
        """Render an (H, W, 2) or (B, H, W, 2) flow (the first of a
        batch) to RGB and log it."""
        flow = torch.as_tensor(flow)
        if flow.ndim == 4:
            flow = flow[0]
        self.image(step, tag, flow_to_image(flow))

    def image(self, step: int, tag: str, img) -> None:
        """Log an (H, W, 3) or (B, H, W, 3) image in [0, 1]."""
        img = torch.as_tensor(img).detach().float().cpu().numpy()
        if img.ndim == 4:
            img = img[0]
        if self._tb is not None:
            self._tb.add_image(tag, np.clip(img, 0.0, 1.0), int(step),
                               dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
