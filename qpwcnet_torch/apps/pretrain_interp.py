"""Frame-interpolation pretraining app (port of
qpwcnet_tpu/apps/pretrain_interp.py), synthetic mode: predict the middle
frame of a triplet from bidirectional flow ("Temporal Interpolation as
an Unsupervised Pretraining Task").

Each step builds its triplet batch on the device
(data/synthetic.py:synthetic_triplet_batch), augments it
(data/augment.py, on by default as in the JAX app) and runs the
pretraining step (the multiscale interpolation loss over all 6 outputs,
l2 term, NaN-grad scrub, AGC, Adam; train/train_state.py). Every
``log_every`` steps it prints the mean loss, the held-out eval MSE with
the running BatchNorm statistics and images/s; at the end the BatchNorm
statistics are recalibrated.

Run: python -m qpwcnet_torch.apps.pretrain_interp --steps 20

Not ported yet, and refused with NotImplementedError rather than
skipped: the datasets (``--data vimeo | ytvos | dummy``) wait for ROADMAP
queue-1 item 8; checkpoints (``--load-ckpt``, saving every
``--ckpt-every`` steps) for item 9; QAT (``--qat``) for item 10; and
``--debug-nan`` (JAX's NaN checker) has no counterpart yet.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from qpwcnet_torch.data.synthetic import stream_seed
from qpwcnet_torch.utils.config import with_args


@dataclasses.dataclass
class Settings:
    """Pretraining settings: the fields of the JAX app's Settings that the
    port reads or refuses (not ``steps_per_call``, which fuses steps into
    one dispatch, nor ``run_root``, where checkpoints go), plus the
    device."""

    data: str = "synthetic"    # only 'synthetic' is ported
    max_disp: float = 24.0     # synthetic flow magnitude bound (px)
    data_path: str = ""
    batch_size: int = 8
    learning_rate: float = 1e-4
    steps: int = 100_000
    height: int = 256
    width: int = 512
    augment: bool = True
    log_every: int = 100
    ckpt_every: int = 2000
    load_ckpt: str = ""
    compute_dtype: str = "float32"  # or 'bfloat16'
    seed: int = 0
    debug_nan: bool = False
    qat: bool = False
    # BatchNorm recalibration passes at the end of training (0: none).
    recalibrate_final: int = 16
    # Head parameterization; the defaults are reference parity.
    head_scale: str = "diag"
    residual: bool = False
    device: str = "cuda"


def _refuse_unported(cfg: Settings) -> None:
    if cfg.data != "synthetic":
        raise NotImplementedError(
            f"--data {cfg.data}: the triplet datasets wait for ROADMAP "
            "queue-1 item 8 (data)")
    if cfg.load_ckpt:
        raise NotImplementedError(
            "--load-ckpt: checkpoints wait for ROADMAP queue-1 item 9")
    if cfg.qat:
        raise NotImplementedError(
            "--qat: quantization-aware training waits for ROADMAP queue-1 "
            "item 10")
    if cfg.debug_nan:
        raise NotImplementedError(
            "--debug-nan: the JAX NaN checker has no counterpart in the "
            "port yet")
    if cfg.ckpt_every <= cfg.steps:
        raise NotImplementedError(
            f"--steps {cfg.steps} reaches --ckpt-every {cfg.ckpt_every}: "
            "checkpoint saving waits for ROADMAP queue-1 item 9; run fewer "
            "steps than --ckpt-every")


def build_model(cfg: Settings) -> torch.nn.Module:
    """The JAX app's model: build_interpolator with cv_impl='auto', from
    cfg.seed (a torch.Generator: other initial values than JAX's key)."""
    from qpwcnet_torch.models import build_interpolator

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    return build_interpolator(cfg.seed, torch.device(cfg.device),
                              dtype=dtype, head_scale=cfg.head_scale,
                              residual=cfg.residual)


def _batch(cfg: Settings, data_seed: int, aug_seed: int,
           augment: bool) -> dict:
    from qpwcnet_torch.data import (
        preprocess_triplet_batch,
        synthetic_triplet_batch,
    )

    gen = torch.Generator(device=cfg.device).manual_seed(data_seed)
    a, b, c = synthetic_triplet_batch(gen, cfg.batch_size, cfg.height,
                                      cfg.width, max_disp=cfg.max_disp)
    aug = torch.Generator(device=cfg.device).manual_seed(aug_seed)
    return preprocess_triplet_batch(aug, a, b, c, augment=augment)


def run(cfg: Settings):
    """Pretrain per cfg; returns (model, the last logged metrics as
    floats: the mean of each step metric since the previous log and
    'mse_eval')."""
    from qpwcnet_torch.train import (
        create_interp_train_state,
        make_interp_train_step,
        recalibrate_batch_stats,
    )

    _refuse_unported(cfg)
    model = build_model(cfg)
    optimizer = create_interp_train_state(model, cfg.learning_rate)
    step = make_interp_train_step()
    # Held-out eval triplet, never trained on: eval-mode final-scale MSE
    # with the running BatchNorm statistics, as deployment runs it.
    held = _batch(cfg, stream_seed(cfg.seed + 999), 0, augment=False)

    def eval_mse() -> float:
        model.eval()
        with torch.no_grad():
            pred = model(held["ims"])
        model.train()
        return float(torch.mean(torch.square(pred - held["mid"])))

    sums, since, logged = None, 0, {}
    t0 = time.time()
    for i in range(cfg.steps):
        batch = _batch(cfg, stream_seed(cfg.seed + 2, i),
                       stream_seed(cfg.seed + 1, i), cfg.augment)
        m = step(model, optimizer, batch)
        sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        since += 1
        if (i + 1) % cfg.log_every == 0:
            logged = {k: float(v) / since for k, v in sums.items()}
            logged["mse_eval"] = eval_mse()
            rate = cfg.batch_size * (i + 1) / (time.time() - t0)
            print(f"step {i + 1}: loss={logged['loss']:.5f} "
                  f"mse_eval={logged['mse_eval']:.5f} ({rate:.1f} img/s)",
                  file=sys.stderr, flush=True)
            sums, since = None, 0
    if cfg.recalibrate_final:
        def calib_ims():
            for j in range(cfg.recalibrate_final):
                yield _batch(cfg, stream_seed(cfg.seed + 2,
                                              1_000_000_000 + j),
                             0, augment=False)["ims"]

        recalibrate_batch_stats(model, calib_ims(), cfg.recalibrate_final)
        print(f"recalibrated BN stats over {cfg.recalibrate_final} batches",
              file=sys.stderr)
    print("final state not saved: checkpoints wait for ROADMAP queue-1 "
          "item 9", file=sys.stderr)
    return model, logged


@with_args(Settings)
def main(cfg: Settings) -> dict:
    _, metrics = run(cfg)
    print(f"done: {cfg.steps} steps, last logged {metrics}", file=sys.stderr)
    return metrics


if __name__ == "__main__":
    main()
