"""Supervised optical-flow training app (port of
qpwcnet_tpu/apps/train_flow.py), synthetic mode.

Each step builds its batch on the device (data/synthetic.py), runs the
train step (multiscale Huber loss, l2 term, NaN-grad scrub, [AGC], Adam;
train/train_state.py) and, every ``log_every`` steps, prints the loss,
the EPE, the held-out EPE with the running BatchNorm statistics, the
predict-zero EPE and images/s. A resolution curriculum (1/4, then 1/2
size) runs first, and the BatchNorm statistics are recalibrated at the
end.

Run: python -m qpwcnet_torch.apps.train_flow --data synthetic --steps 20

Not ported yet, and refused with NotImplementedError rather than
skipped: the datasets and the host generator (``--data fc3d | sintel |
synthetic-uniform``) and augmentation wait for ROADMAP queue-1 item 8;
checkpoints (``--load-ckpt``, ``--transfer-from-interp``, saving every
``--ckpt-every`` steps) for item 9; QAT (``--qat``) for item 10.
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
    """Flow training settings: the fields of the JAX app's Settings that
    the port reads or refuses (not ``steps_per_call``, which fuses steps
    into one dispatch, nor ``run_root``, where checkpoints go), plus the
    device."""

    data: str = "synthetic"   # only 'synthetic' is ported
    max_disp: float = 24.0    # synthetic flow magnitude bound (px)
    data_path: str = ""
    batch_size: int = 16
    learning_rate: float = 1e-4
    steps: int = 100_000
    height: int = 256
    width: int = 512
    base_scale: float = 1.0   # augmentation only
    augment: str = "auto"     # 'auto' is off for synthetic data
    log_every: int = 100
    ckpt_every: int = 2000
    load_ckpt: str = ""
    transfer_from_interp: bool = False
    compute_dtype: str = "float32"  # or 'bfloat16'
    # Trainable head parameterization: from scratch, unit+residual
    # converges where reference parity ('diag', no residual) does not.
    head_scale: str = "unit"
    residual: bool = True
    # 'auto': the plain chain (NaN scrub + Adam, no l2) for synthetic
    # data, the reference chain (NaN scrub + AGC + Adam, l2 4e-6) else.
    optimizer: str = "auto"
    # 1/4- and 1/2-resolution warm-up stage steps ('' disables).
    curriculum: str = "5000,4000"
    seed: int = 0
    qat: bool = False
    # BatchNorm recalibration passes at the end of training (0: none).
    recalibrate_final: int = 16
    device: str = "cuda"


def _refuse_unported(cfg: Settings) -> None:
    if cfg.data != "synthetic":
        raise NotImplementedError(
            f"--data {cfg.data}: the datasets and the host generator wait "
            "for ROADMAP queue-1 item 8 (data)")
    if cfg.augment == "on":
        raise NotImplementedError(
            "--augment on: augmentation waits for ROADMAP queue-1 item 8")
    if cfg.load_ckpt or cfg.transfer_from_interp:
        raise NotImplementedError(
            "--load-ckpt / --transfer-from-interp: checkpoints wait for "
            "ROADMAP queue-1 item 9")
    if cfg.qat:
        raise NotImplementedError(
            "--qat: quantization-aware training waits for ROADMAP queue-1 "
            "item 10")
    if cfg.ckpt_every <= cfg.steps:
        raise NotImplementedError(
            f"--steps {cfg.steps} reaches --ckpt-every {cfg.ckpt_every}: "
            "checkpoint saving waits for ROADMAP queue-1 item 9; run fewer "
            "steps than --ckpt-every")


def _resolve_optimizer(cfg: Settings):
    """('plain'|'reference', l2_gamma) per cfg.optimizer/'auto'."""
    plain = cfg.optimizer == "plain" or (
        cfg.optimizer == "auto" and cfg.data == "synthetic")
    return ("plain" if plain else "reference"), (0.0 if plain else 4e-6)


def _make_optimizer(kind: str, model, lr: float):
    from qpwcnet_torch.train import default_optimizer, plain_optimizer

    if kind == "plain":
        return plain_optimizer(model, lr)
    return default_optimizer(model, lr)


def build_model(cfg: Settings) -> torch.nn.Module:
    """The JAX app's model: build_flow_net with cv_impl='auto', from
    cfg.seed (a torch.Generator: other initial values than JAX's key)."""
    from qpwcnet_torch.models import build_flow_net

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    return build_flow_net(cfg.seed, torch.device(cfg.device), dtype=dtype,
                          head_scale=cfg.head_scale, residual=cfg.residual)


def _batch(cfg: Settings, seed: int, h: int, w: int, disp: float) -> dict:
    from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch

    gen = torch.Generator(device=cfg.device).manual_seed(seed)
    ims_u8, flo = synthetic_flow_batch(gen, cfg.batch_size, h, w,
                                       max_disp=disp)
    return preprocess_flow_batch(ims_u8, flo, out_hw=(h, w))


def _train(cfg: Settings, model, optimizer, l2_gamma: float, n_steps: int,
           h: int, w: int, disp: float, stream: tuple, tag: str) -> dict:
    """n_steps train steps on stream ``stream`` at (h, w), logging every
    cfg.log_every steps; returns the last step's metrics (floats)."""
    from qpwcnet_torch.data import zero_baseline_epe
    from qpwcnet_torch.train import epe_error, make_flow_train_step

    step = make_flow_train_step(l2_gamma)
    held = _batch(cfg, stream_seed(cfg.seed + 999), h, w, disp)
    epe_zero = float(zero_baseline_epe(held["flo"]))
    sums = None
    since = 0
    t0 = time.time()
    m = {}
    for i in range(n_steps):
        batch = _batch(cfg, stream_seed(*stream, i), h, w, disp)
        m = step(model, optimizer, batch)
        sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        since += 1
        if (i + 1) % cfg.log_every == 0:
            model.eval()
            with torch.no_grad():
                epe_eval = float(epe_error(held["flo"], model(held["ims"])))
            model.train()
            mean = {k: float(v) / since for k, v in sums.items()}
            rate = cfg.batch_size * (i + 1) / (time.time() - t0)
            print(f"{tag}step {i + 1}: loss={mean['loss']:.4f} "
                  f"epe={mean['epe']:.3f} epe_eval={epe_eval:.3f} "
                  f"epe_zero={epe_zero:.3f} ({rate:.1f} img/s)",
                  file=sys.stderr, flush=True)
            sums, since = None, 0
    return {k: float(v) for k, v in m.items()}


def run(cfg: Settings):
    """Train per cfg; returns (model, the last step's metrics)."""
    from qpwcnet_torch.data import synthetic_flow_batch
    from qpwcnet_torch.train import recalibrate_batch_stats

    _refuse_unported(cfg)
    model = build_model(cfg)
    kind, l2_gamma = _resolve_optimizer(cfg)

    # Resolution curriculum: the parameters are resolution-independent,
    # so ignite at (h/4, w/4, disp/3, lr*10/3), consolidate at (h/2,
    # w/2, disp/2, lr*5/3), each stage with a fresh Adam state.
    stage_steps = [int(s) for s in cfg.curriculum.split(",") if s]
    for n_steps, div in zip(stage_steps, (4, 2)):
        if cfg.height % (32 * div) or cfg.width % (32 * div):
            print(f"[curriculum] skip 1/{div} stage: {cfg.height}x"
                  f"{cfg.width} not divisible by {32 * div}",
                  file=sys.stderr)
            continue
        lr = cfg.learning_rate * {4: 10.0 / 3.0, 2: 5.0 / 3.0}[div]
        _train(cfg, model, _make_optimizer(kind, model, lr), l2_gamma,
               n_steps, cfg.height // div, cfg.width // div,
               cfg.max_disp / {4: 3.0, 2: 2.0}[div], (cfg.seed + 2, div),
               f"[curriculum 1/{div}] ")

    metrics = _train(cfg, model,
                     _make_optimizer(kind, model, cfg.learning_rate),
                     l2_gamma, cfg.steps, cfg.height, cfg.width,
                     cfg.max_disp, (cfg.seed + 2,), "")
    if cfg.recalibrate_final:
        def calib_ims():
            for j in range(cfg.recalibrate_final):
                gen = torch.Generator(device=cfg.device).manual_seed(
                    stream_seed(cfg.seed + 2, 1_000_000_000 + j))
                ims_u8, _ = synthetic_flow_batch(
                    gen, cfg.batch_size, cfg.height, cfg.width,
                    max_disp=cfg.max_disp)
                yield ims_u8.float() / 255.0 - 0.5

        recalibrate_batch_stats(model, calib_ims(), cfg.recalibrate_final)
        print(f"recalibrated BN stats over {cfg.recalibrate_final} batches",
              file=sys.stderr)
    print("final state not saved: checkpoints wait for ROADMAP queue-1 "
          "item 9", file=sys.stderr)
    return model, metrics


@with_args(Settings)
def main(cfg: Settings) -> dict:
    _, metrics = run(cfg)
    print(f"done: {cfg.steps} steps, last step {metrics}", file=sys.stderr)
    return metrics


if __name__ == "__main__":
    main()
