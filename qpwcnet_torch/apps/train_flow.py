"""Supervised optical-flow training app (port of
qpwcnet_tpu/apps/train_flow.py), synthetic mode.

Each run makes the next run directory under ``--run-root``
(``NNN/{log,ckpt}``, ``config.json``). Each step builds its batch on the
device (data/synthetic.py) from the seed and the global step index, and
runs the train step (multiscale Huber loss, l2 term, NaN-grad scrub,
[AGC], Adam; train/train_state.py). Every ``log_every`` steps it prints
and writes to ``log/metrics.jsonl`` the loss, the EPE, the held-out EPE
with the running BatchNorm statistics, the predict-zero EPE and
images/s; every ``ckpt_every`` steps, and on an interrupt, it saves a
checkpoint. A resolution curriculum (1/4, then 1/2 size) runs first on
a fresh run, and the BatchNorm statistics are recalibrated before the
final save.

``--load-ckpt <ckpt dir>`` resumes from that directory's latest
checkpoint (model, optimizer and step): a run interrupted and resumed
with ``--curriculum ''`` replays the uninterrupted one. With
``--transfer-from-interp true`` it instead copies the encoder, decoder
and flower of a ``pretrain_interp`` checkpoint into the fresh model.

Run: python -m qpwcnet_torch.apps.train_flow --data synthetic --steps 20

Not ported yet, and refused with NotImplementedError rather than
skipped: the datasets and the host generator (``--data fc3d | sintel |
synthetic-uniform``) and augmentation wait for ROADMAP queue 1, data;
QAT (``--qat``) for ROADMAP queue 1, quantization.
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
    into one dispatch), plus the device."""

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
    run_root: str = ""        # default: <tempdir>/qpwcnet_torch/run
    load_ckpt: str = ""       # ckpt dir to resume / transfer from
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
            "for ROADMAP queue 1, data")
    if cfg.augment == "on":
        raise NotImplementedError(
            "--augment on: the flow augmentation waits for ROADMAP queue 1, "
            "data")
    if cfg.qat:
        raise NotImplementedError(
            "--qat: quantization-aware training waits for ROADMAP queue 1, "
            "quantization")


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


def _dtype(cfg: Settings) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32


def build_model(cfg: Settings) -> torch.nn.Module:
    """The JAX app's model: build_flow_net with cv_impl='auto', from
    cfg.seed (a torch.Generator: other initial values than JAX's key)."""
    from qpwcnet_torch.models import build_flow_net

    return build_flow_net(cfg.seed, torch.device(cfg.device),
                          dtype=_dtype(cfg), head_scale=cfg.head_scale,
                          residual=cfg.residual)


def _batch(cfg: Settings, seed: int, h: int, w: int, disp: float) -> dict:
    from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch

    gen = torch.Generator(device=cfg.device).manual_seed(seed)
    ims_u8, flo = synthetic_flow_batch(gen, cfg.batch_size, h, w,
                                       max_disp=disp)
    return preprocess_flow_batch(ims_u8, flo, out_hw=(h, w))


def _train(cfg: Settings, model, optimizer, l2_gamma: float,
           steps: range, h: int, w: int, disp: float, stream: tuple,
           tag: str, writer=None, ckpt=None) -> dict:
    """The train steps ``steps`` (global indices) at (h, w), step i on
    the batch of ``stream_seed(*stream, i)``; every cfg.log_every steps
    a log line (and a ``writer`` record), every cfg.ckpt_every a save to
    ``ckpt`` labelled i + 1. Returns the last step's metrics (floats)."""
    from qpwcnet_torch.data import zero_baseline_epe
    from qpwcnet_torch.train import epe_error, make_flow_train_step

    step = make_flow_train_step(l2_gamma)
    held = _batch(cfg, stream_seed(cfg.seed + 999), h, w, disp)
    epe_zero = float(zero_baseline_epe(held["flo"]))
    sums = None
    since = 0
    t0 = time.time()
    m = {}
    for i in steps:
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
            rate = cfg.batch_size * (i + 1 - steps.start) / (
                time.time() - t0)
            if writer is not None:
                writer.scalars(i + 1, {**mean, "epe_eval": epe_eval,
                                       "epe_zero": epe_zero,
                                       "images_per_sec": rate})
            print(f"{tag}step {i + 1}: loss={mean['loss']:.4f} "
                  f"epe={mean['epe']:.3f} epe_eval={epe_eval:.3f} "
                  f"epe_zero={epe_zero:.3f} ({rate:.1f} img/s)",
                  file=sys.stderr, flush=True)
            sums, since = None, 0
        if ckpt is not None and (i + 1) % cfg.ckpt_every == 0:
            ckpt.save(i + 1, model, optimizer)
    return {k: float(v) for k, v in m.items()}


def _restore(cfg: Settings, model, optimizer, ckpt) -> None:
    """--load-ckpt: a full restore (model, optimizer, step), or with
    --transfer-from-interp the encoder, decoder and flower of the JAX
    app's interpolator restored from it; else the auto-resume from the
    run's own ckpt/ (a new run directory: none yet)."""
    from qpwcnet_torch.train import (
        CheckpointManager,
        create_interp_train_state,
        transfer_params,
    )

    if not cfg.load_ckpt:
        ckpt.restore(model, optimizer)
        return
    src = CheckpointManager(cfg.load_ckpt)
    if cfg.transfer_from_interp:
        from qpwcnet_torch.models import build_interpolator

        imodel = build_interpolator(0, torch.device(cfg.device),
                                    dtype=_dtype(cfg))
        src.restore(imodel, create_interp_train_state(imodel))
        transfer_params(imodel, model)
    else:
        src.restore(model, optimizer)
    src.close()


def _curriculum(cfg: Settings, model, optimizer, kind: str,
                l2_gamma: float) -> None:
    """The resolution curriculum of a fresh run: the parameters are
    resolution-independent, so ignite at (h/4, w/4, disp/3, lr*10/3),
    consolidate at (h/2, w/2, disp/2, lr*5/3), each stage with a fresh
    Adam state. Its steps count in ``optimizer.global_step``; the main
    loop then takes ``optimizer``, not stepped yet."""
    stage_steps = [int(s) for s in cfg.curriculum.split(",") if s]
    for n_steps, div in zip(stage_steps, (4, 2)):
        if cfg.height % (32 * div) or cfg.width % (32 * div):
            print(f"[curriculum] skip 1/{div} stage: {cfg.height}x"
                  f"{cfg.width} not divisible by {32 * div}",
                  file=sys.stderr)
            continue
        lr = cfg.learning_rate * {4: 10.0 / 3.0, 2: 5.0 / 3.0}[div]
        stage = _make_optimizer(kind, model, lr)
        stage.global_step = optimizer.global_step
        _train(cfg, model, stage, l2_gamma, range(n_steps),
               cfg.height // div, cfg.width // div,
               cfg.max_disp / {4: 3.0, 2: 2.0}[div], (cfg.seed + 2, div),
               f"[curriculum 1/{div}] ")
        optimizer.global_step = stage.global_step


def _recalibrate(cfg: Settings, model) -> None:
    """Re-estimate the BatchNorm statistics over cfg.recalibrate_final
    unaugmented batches of their own stream."""
    from qpwcnet_torch.data import synthetic_flow_batch
    from qpwcnet_torch.train import recalibrate_batch_stats

    def calib_ims():
        for j in range(cfg.recalibrate_final):
            gen = torch.Generator(device=cfg.device).manual_seed(
                stream_seed(cfg.seed + 2, 1_000_000_000 + j))
            ims_u8, _ = synthetic_flow_batch(
                gen, cfg.batch_size, cfg.height, cfg.width,
                max_disp=cfg.max_disp)
            yield ims_u8.float() / 255.0 - 0.5

    recalibrate_batch_stats(model, calib_ims(), cfg.recalibrate_final)
    print(f"recalibrated BN stats over {cfg.recalibrate_final} batches "
          "before the final save", file=sys.stderr)


def run(cfg: Settings):
    """Train per cfg; returns (model, the last step's metrics)."""
    from qpwcnet_torch.train import CheckpointManager, MetricWriter
    from qpwcnet_torch.utils.runs import setup_run_dir, snapshot_config

    _refuse_unported(cfg)
    paths = setup_run_dir(cfg.run_root)
    snapshot_config(paths["run"], cfg)
    print(f"run dir: {paths['run']}", file=sys.stderr)

    model = build_model(cfg)
    kind, l2_gamma = _resolve_optimizer(cfg)
    optimizer = _make_optimizer(kind, model, cfg.learning_rate)
    ckpt = CheckpointManager(paths["ckpt"])
    _restore(cfg, model, optimizer, ckpt)
    # JAX reads the step before the curriculum, whose steps the stored
    # step counts and the main loop's labels do not
    step0 = optimizer.global_step
    if cfg.curriculum and step0 == 0 and not cfg.load_ckpt:
        _curriculum(cfg, model, optimizer, kind, l2_gamma)

    metrics = {}
    writer = MetricWriter(paths["log"])
    try:
        metrics = _train(cfg, model, optimizer, l2_gamma,
                         range(step0, cfg.steps), cfg.height, cfg.width,
                         cfg.max_disp, (cfg.seed + 2,), "", writer, ckpt)
    except KeyboardInterrupt:
        print("interrupted; saving", file=sys.stderr)
    finally:
        writer.close()
    if cfg.recalibrate_final:
        _recalibrate(cfg, model)
    # labelled by the stored step: at a periodic save's label (no
    # curriculum, steps a multiple of ckpt_every) a no-op, as in JAX
    ckpt.save(optimizer.global_step, model, optimizer)
    ckpt.wait()
    return model, metrics


@with_args(Settings)
def main(cfg: Settings) -> dict:
    _, metrics = run(cfg)
    print(f"done: {cfg.steps} steps, last step {metrics}", file=sys.stderr)
    return metrics


if __name__ == "__main__":
    main()
