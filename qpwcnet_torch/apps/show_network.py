"""Model inspection app (port of qpwcnet_tpu/apps/show_network.py): the
parameter-count tree, the forward's flops and bytes
(``utils/profiling.py:cost_analysis``), its time and achieved TFLOP/s,
and, with ``--trace-dir``, a torch.profiler trace of one forward
(Chrome/Perfetto JSON; JAX's writes an XProf trace) that shows the
model's levels as ``qpwcnet.<span>`` ranges (``utils/tracing.py``).

The model is the JAX app's: ``build_flow_net`` or ``build_interpolator``
from seed 0 (cv_impl='auto': the cost volumes run the CUDA kernel K1 on
the card), one zero (1, H, W, 6) input, eval mode.

Run: python -m qpwcnet_torch.apps.show_network --model flow --height 256
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from qpwcnet_torch.utils import tracing
from qpwcnet_torch.utils.config import with_args


@dataclasses.dataclass
class Settings:
    model: str = "flow"       # 'flow' | 'interp'
    height: int = 256
    width: int = 512
    trace_dir: str = ""       # write a torch.profiler trace here if set
    compute_dtype: str = "float32"
    device: str = "cuda"


def run(cfg: Settings) -> dict:
    """Print the summary per cfg; returns {'params', 'flops', 'bytes',
    'forward_s', 'tflops'} and, with a trace, 'trace_dir'."""
    from qpwcnet_torch.models import build_flow_net, build_interpolator
    from qpwcnet_torch.utils.profiling import (
        cost_analysis,
        summarize_model,
        time_fn,
        trace,
    )

    if cfg.model not in ("flow", "interp"):
        raise ValueError(f"unknown model {cfg.model!r}")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    build = build_flow_net if cfg.model == "flow" else build_interpolator
    dev = torch.device(cfg.device)
    model = build(0, dev, dtype=dtype)

    summary = summarize_model(model)
    print(summary)

    def forward(ims):
        with torch.inference_mode():
            return model(ims)

    ims = torch.zeros((1, cfg.height, cfg.width, 6), dtype=torch.float32,
                      device=dev)
    analysis = cost_analysis(forward, ims)
    flops = analysis["flops"]
    print(f"\ncost analysis: {flops / 1e9:.2f} GFLOP/forward, "
          f"{analysis['bytes accessed'] / 1e6:.1f} MB accessed")

    dt = time_fn(forward, ims, iters=10)
    print(f"forward: {dt * 1e3:.2f} ms "
          f"({flops / dt / 1e12:.2f} TFLOP/s achieved)")
    out = {"params": sum(p.numel() for p in model.parameters()),
           "flops": flops, "bytes": analysis["bytes accessed"],
           "forward_s": dt, "tflops": flops / dt / 1e12}

    if cfg.trace_dir:
        was = tracing.enable()
        try:
            with trace(cfg.trace_dir):
                forward(ims)
        finally:
            tracing.enable(was)
        print(f"trace written to {cfg.trace_dir}", file=sys.stderr)
        out["trace_dir"] = cfg.trace_dir
    return out


@with_args(Settings)
def main(cfg: Settings) -> dict:
    return run(cfg)


if __name__ == "__main__":
    main()
