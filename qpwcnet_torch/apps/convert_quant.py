"""QAT -> int8 deployment export (port of
qpwcnet_tpu/apps/convert_quant.py).

The deployment artifact is the int8 weight bundle (``.npz``: int8
kernels, per-channel scales and the QAT activation ranges, in the JAX
package's layout, quantize/int8.py) and the int8-executing model
(``QuantConfig(mode='int8')``), whose forward ``--export`` writes with
``torch.export``.

  * Without a checkpoint, or with ``--load-ckpt`` (a ``train_flow --qat``
    checkpoint directory) whose ranges are all 0, ``--steps`` QAT steps on
    random batches calibrate the ranges first.
  * ``--float-ckpt`` (a float ``train_flow`` checkpoint directory): the EPE
    gate. A QAT fine-tune from the float weights (``--qat-steps``), joint
    calibration of the ranges and the BatchNorm statistics
    (``--calib-passes`` train-mode forwards), then the bf16 int8 model's
    EPE against the bf16 float model's (its BatchNorm statistics
    re-estimated on the same distribution) on synthetic known-flow
    batches, printed as one JSON line on stderr.
  * ``--check true`` reports the int8 model's mean |Δflow| against the
    float model with the same parameters on a random input, as % of the
    mean |flow|.
  * ``--export out.pt2`` writes the int8 forward (batch 1, the run's
    height and width) as a ``torch.export`` program, on the card with the
    cost-volume kernel as the op ``qpwcnet::cost_volume``; load it with
    ``import qpwcnet_torch.ops.cuda`` first.

Run: python -m qpwcnet_torch.apps.convert_quant --steps 3 --check true
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from qpwcnet_torch.utils.config import with_args


@dataclasses.dataclass
class Settings:
    load_ckpt: str = ""        # QAT run ckpt dir ('' = fresh QAT on noise)
    steps: int = 3             # calibration QAT steps when no ranges
    height: int = 256
    width: int = 512
    out: str = ""  # default: <tempdir>/qpwcnet_torch/qpwcnet_int8.npz
    check: bool = True
    export: str = ""           # torch.export of the int8 forward (.pt2)
    # EPE gate: a trained FLOAT checkpoint, QAT fine-tuned and calibrated,
    # then int8 against float EPE on synthetic known-flow batches
    float_ckpt: str = ""
    gate_batches: int = 4
    gate_batch_size: int = 4
    calib_passes: int = 200    # BN + activation-range calibration passes
    qat_steps: int = 300       # QAT fine-tune steps before conversion
    qat_lr: float = 3e-5
    device: str = "cuda"


def twin(model, device, dtype=torch.float32, quant=None,
         state: dict | None = None):
    """A PWCFlowNet (JAX's: 'diag' heads, no residual) in ``dtype`` with
    ``quant``, holding ``model``'s parameters and BatchNorm statistics (and
    its ranges, where the twin has them), or those of ``state``."""
    from qpwcnet_torch.models import build_flow_net

    out = build_flow_net(0, device, dtype=dtype, quant=quant)
    keys = out.state_dict().keys()
    src = model.state_dict() if state is None else state
    out.load_state_dict({k: v for k, v in src.items() if k in keys})
    return out


def _epe_gate(cfg: Settings, model, quant) -> dict:
    """The int8-against-float EPE of a trained float checkpoint (loaded
    into the QAT ``model``), after a QAT fine-tune and the joint
    calibration. The float baseline keeps the original weights: the QAT
    fine-tune adapts them to quantization, which costs their float-mode
    quality."""
    from qpwcnet_torch.apps.train_flow import Settings as TrainSettings
    from qpwcnet_torch.apps.train_flow import _synthetic_batches
    from qpwcnet_torch.quantize.qlayers import quant_ranges
    from qpwcnet_torch.train import (
        default_optimizer,
        epe_error,
        make_flow_train_step,
        recalibrate_batch_stats,
    )

    dev = torch.device(cfg.device)
    gen = _synthetic_batches(TrainSettings(
        batch_size=cfg.gate_batch_size, height=cfg.height, width=cfg.width,
        seed=123))

    def next_batch():
        ims_u8, flo = next(gen)
        return (torch.from_numpy(ims_u8).to(dev).float() / 255.0 - 0.5,
                torch.from_numpy(flo).to(dev))

    ranges = quant_ranges(model)
    float_state = {k: v.clone() for k, v in model.state_dict().items()
                   if k not in ranges}
    if cfg.qat_steps:
        chain = default_optimizer(model, cfg.qat_lr)
        step = make_flow_train_step()
        for i in range(cfg.qat_steps):
            ims, flo = next_batch()
            m = step(model, chain, {"ims": ims, "flo": flo})
            if (i + 1) % 100 == 0:
                print(f"qat step {i + 1}: loss={float(m['loss']):.4f} "
                      f"epe={float(m['epe']):.2f}", file=sys.stderr)
    # joint calibration: the ranges (int8) and the BatchNorm statistics
    model.train()
    with torch.no_grad():
        for _ in range(cfg.calib_passes):
            model(next_batch()[0])
    model.eval()

    bf16 = torch.bfloat16
    int8_model = twin(model, dev, bf16, dataclasses.replace(quant,
                                                           mode="int8"))
    float_model = twin(model, dev, bf16, state=float_state)
    recalibrate_batch_stats(
        float_model, (next_batch()[0] for _ in range(cfg.calib_passes)),
        cfg.calib_passes)
    epes_f, epes_q = [], []
    with torch.no_grad():
        for _ in range(cfg.gate_batches):
            ims, flo = next_batch()
            epes_f.append(float(epe_error(flo, float_model(ims))))
            epes_q.append(float(epe_error(flo, int8_model(ims))))
    epe_f, epe_q = float(np.mean(epes_f)), float(np.mean(epes_q))
    gate = {"metric": "int8-vs-float EPE delta (trained ckpt, synthetic)",
            "epe_float": round(epe_f, 4), "epe_int8": round(epe_q, 4),
            "rel_delta": round((epe_q - epe_f) / max(epe_f, 1e-9), 4)}
    print(json.dumps(gate), file=sys.stderr)
    return gate


def _calibrate(cfg: Settings, model, chain) -> None:
    """cfg.steps QAT train steps on random batches (batch 1) to populate
    the ranges."""
    from qpwcnet_torch.train import make_flow_train_step

    print(f"calibrating ranges with {cfg.steps} QAT steps", file=sys.stderr)
    dev = torch.device(cfg.device)
    step = make_flow_train_step()
    rng = np.random.RandomState(0)
    for _ in range(cfg.steps):
        ims = rng.uniform(-0.5, 0.5, (1, cfg.height, cfg.width, 6))
        flo = rng.uniform(-4, 4, (1, cfg.height, cfg.width, 2))
        step(model, chain, {
            "ims": torch.from_numpy(ims.astype(np.float32)).to(dev),
            "flo": torch.from_numpy(flo.astype(np.float32)).to(dev)})


def export_int8(model, path, example: torch.Tensor) -> None:
    """``torch.export`` of the int8 model's forward on inputs shaped like
    ``example`` (on the card: the CUDA kernels K1 and K3 as the custom ops
    ``qpwcnet::cost_volume`` and ``qpwcnet::warp_cost_volume``), saved to
    ``path``. A forward the exporter cannot trace raises the exporter's
    own error. A program holding the ops loads after
    ``import qpwcnet_torch.ops.cuda``, which registers them."""
    exported = torch.export.export(model, (example,))
    torch.export.save(exported, str(path))


def run(cfg: Settings) -> dict:
    """Convert per cfg; returns {'bundle' (its path), 'int8' (the
    bundle written), 'n_convs', 'n_int8_weights'} and, as set, the
    check's and the gate's numbers."""
    from qpwcnet_torch.models import build_flow_net
    from qpwcnet_torch.quantize import (
        QuantConfig,
        convert_to_int8,
        save_int8_bundle,
    )
    from qpwcnet_torch.quantize.qlayers import quant_ranges
    from qpwcnet_torch.train import CheckpointManager, default_optimizer

    dev = torch.device(cfg.device)
    quant = QuantConfig()
    model = build_flow_net(0, dev, quant=quant)
    chain = default_optimizer(model)
    out = {}
    if cfg.float_ckpt:
        mgr = CheckpointManager(cfg.float_ckpt)
        if mgr.restore_params(model) is None:
            raise FileNotFoundError(f"no checkpoint in {cfg.float_ckpt}")
        out["gate"] = _epe_gate(cfg, model, quant)
    elif cfg.load_ckpt:
        if CheckpointManager(cfg.load_ckpt).restore(model, chain) is None:
            raise FileNotFoundError(f"no checkpoint in {cfg.load_ckpt}")
    if not max((float(b.max()) for b in quant_ranges(model).values()),
               default=0.0):
        _calibrate(cfg, model, chain)
    model.eval()

    bundle = convert_to_int8(model)
    path = Path(cfg.out or Path(tempfile.gettempdir()) / "qpwcnet_torch"
                / "qpwcnet_int8.npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    save_int8_bundle(path, bundle)
    n_int8 = sum(c.kernel_i8.size for c in bundle.values())
    print(f"wrote {path}: {len(bundle)} convs, {n_int8 / 1e6:.2f}M int8 "
          "weights", file=sys.stderr)
    out.update(bundle=str(path), int8=bundle, n_convs=len(bundle),
               n_int8_weights=n_int8)

    int8_quant = dataclasses.replace(quant, mode="int8")
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.5, 0.5, (1, cfg.height, cfg.width, 6)).astype(np.float32)).to(dev)
    if cfg.check:
        with torch.no_grad():
            q_out = twin(model, dev, quant=int8_quant)(x)
            f_out = twin(model, dev)(x)
        err = float((q_out - f_out).abs().mean())
        mag = float(f_out.abs().mean()) + 1e-9
        print(f"int8 vs float flow: mean|delta|={err:.4f} "
              f"({100 * err / mag:.1f}% of mean|flow|)", file=sys.stderr)
        out.update(check_mean_abs_delta=err, check_pct=100 * err / mag)
    if cfg.export:
        export_int8(twin(model, dev, quant=int8_quant), cfg.export, x)
        print(f"torch.export -> {cfg.export}", file=sys.stderr)
        out["export"] = cfg.export
    return out


@with_args(Settings)
def main(cfg: Settings) -> dict:
    return run(cfg)


if __name__ == "__main__":
    main()
