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

Each run makes the next run directory under ``--run-root``
(``NNN/{log,ckpt}``, ``config.json``), writes every logged scalar to
``log/metrics.jsonl`` and saves a checkpoint every ``ckpt_every`` steps,
on an interrupt and after the recalibration. Batches and augmentation
draws are indexed by the global step, so a run resumed with
``--load-ckpt <ckpt dir>`` replays the uninterrupted one.

The dataset modes, ``--data vimeo`` (Vimeo-90K triplets, ``--data-path``
its root, split 'train'), ``ytvos`` (YouTube-VOS, split 'train') and
``dummy`` (black frames): host threads decode the frames, resized to
``--height x --width``, and batch them (data/pipeline.py:PrefetchLoader,
this process's shard of the dataset); the step runs on the data-parallel
mesh with the augmentation draws of the global step; the log carries the
step's loss, images/s and the ms a step waited on the loader, and the
recalibration runs on further unaugmented batches. A resumed run starts
the dataset again from its first epoch, as JAX's does.

``--qat true`` pretrains the quantization-aware interpolator
(``QuantConfig()``) in every data mode; its checkpoints carry the
activation ranges, and ``--load-ckpt`` of a float run starts a QAT
fine-tune from it.

``--debug-nan true`` (JAX's ``jax_debug_nans``) runs every step under
autograd's anomaly mode and raises FloatingPointError at the first NaN
in a forward output, the loss or a gradient, before the NaN scrub
(``train.make_interp_train_step(debug_nan=True)``); the losses are those
of the run without it.

Run: python -m qpwcnet_torch.apps.pretrain_interp --steps 20
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from qpwcnet_torch.data.synthetic import stream_seed
from qpwcnet_torch.utils.config import with_args

DATA_MODES = ("synthetic", "vimeo", "ytvos", "dummy")


@dataclasses.dataclass
class Settings:
    """Pretraining settings: the fields of the JAX app's Settings that the
    port reads or refuses (not ``steps_per_call``, which fuses steps into
    one dispatch), plus the device."""

    data: str = "synthetic"    # DATA_MODES
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
    run_root: str = ""         # default: <tempdir>/qpwcnet_torch/pretrain
    load_ckpt: str = ""        # ckpt dir to resume from
    compute_dtype: str = "float32"  # or 'bfloat16'
    seed: int = 0
    debug_nan: bool = False
    # quantization-aware training (QuantConfig()); ranges checkpointed
    qat: bool = False
    # BatchNorm recalibration passes at the end of training (0: none).
    recalibrate_final: int = 16
    # Head parameterization; the defaults are reference parity.
    head_scale: str = "diag"
    residual: bool = False
    device: str = "cuda"


def _check_settings(cfg: Settings) -> None:
    if cfg.data not in DATA_MODES:
        raise ValueError(f"unknown data source {cfg.data!r}")


def build_model(cfg: Settings) -> torch.nn.Module:
    """The JAX app's model: build_interpolator with cv_impl='auto' (and
    QuantConfig() under --qat), from cfg.seed (a torch.Generator: other
    initial values than JAX's key)."""
    from qpwcnet_torch.models import build_interpolator
    from qpwcnet_torch.quantize import QuantConfig

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    return build_interpolator(cfg.seed, torch.device(cfg.device),
                              dtype=dtype, head_scale=cfg.head_scale,
                              residual=cfg.residual,
                              quant=QuantConfig() if cfg.qat else None)


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


def _make_dataset(cfg: Settings):
    """The triplet dataset of cfg.data: Vimeo-90K's or YouTube-VOS's
    'train' split under cfg.data_path, or max(4 batches, 32) black
    triplets."""
    from qpwcnet_torch.data.triplet import (
        DummyTripletDataset,
        VimeoTriplet,
        YoutubeVos,
    )

    if cfg.data == "vimeo":
        return VimeoTriplet(cfg.data_path, "train")
    if cfg.data == "ytvos":
        return YoutubeVos(cfg.data_path, "train")
    return DummyTripletDataset(n=max(cfg.batch_size * 4, 32),
                               hw=(cfg.height, cfg.width))


def _triplet_loader(cfg: Settings, shard_index: int = 0,
                    shard_count: int = 1):
    """The PrefetchLoader of cfg's triplet dataset (JAX's defaults: seed
    0, shuffled, 4 workers), frames resized to (height, width), over this
    process's shard."""
    from qpwcnet_torch.data.pipeline import PrefetchLoader, triplet_sample_fn

    dataset = _make_dataset(cfg)
    return PrefetchLoader(
        triplet_sample_fn(dataset, (cfg.height, cfg.width)), len(dataset),
        cfg.batch_size, shard_index=shard_index, shard_count=shard_count)


def _pretrain_on_dataset(cfg: Settings, model, optimizer, ckpt, writer,
                         step0: int) -> dict:
    """The dataset modes: this process's loader batches, preprocessed
    (augmented with the draws of the global step) on the device and
    stepped on the data-parallel mesh; then the BatchNorm recalibration
    on further unaugmented batches. Returns the last logged metrics."""
    from qpwcnet_torch.data import preprocess_triplet_batch
    from qpwcnet_torch.parallel import (
        make_mesh_for_batch,
        make_parallel_step,
        process_shard,
        put_batch,
        replicate,
    )
    from qpwcnet_torch.train import (
        make_interp_train_step,
        recalibrate_batch_stats,
    )

    mesh = make_mesh_for_batch(cfg.batch_size)
    replicate(model, mesh)
    step_fn = make_parallel_step(
        make_interp_train_step(debug_nan=cfg.debug_nan), mesh)
    loader = _triplet_loader(cfg, *process_shard())
    batches = iter(loader)
    dev = torch.device(cfg.device)

    def prepare(frames, aug_seed=None) -> dict:
        a, b, c = (torch.from_numpy(f).to(dev) for f in frames)
        gen = None
        if aug_seed is not None:
            gen = torch.Generator(device=dev).manual_seed(aug_seed)
        return preprocess_triplet_batch(gen, a, b, c,
                                        augment=aug_seed is not None)

    logged, waited = {}, 0.0
    t0 = time.time()
    try:
        for i in range(step0, cfg.steps):
            t_wait = time.perf_counter()
            frames = next(batches)
            waited += time.perf_counter() - t_wait
            batch = put_batch(prepare(frames, stream_seed(cfg.seed + 1, i)
                                      if cfg.augment else None), mesh, dev)
            m = step_fn(model, optimizer, batch)
            if (i + 1) % cfg.log_every == 0:
                logged = {k: float(v) for k, v in m.items()}
                logged["loader_wait_ms"] = 1e3 * waited / cfg.log_every
                waited = 0.0
                rate = cfg.batch_size * (i + 1 - step0) / (time.time() - t0)
                writer.scalars(i + 1, {**logged, "images_per_sec": rate})
                print(f"step {i + 1}: loss={logged['loss']:.5f} "
                      f"({rate:.1f} img/s, loader wait "
                      f"{logged['loader_wait_ms']:.1f} ms a step)",
                      file=sys.stderr, flush=True)
            if (i + 1) % cfg.ckpt_every == 0:
                ckpt.save(i + 1, model, optimizer)
    except KeyboardInterrupt:
        print("interrupted; saving", file=sys.stderr)
    finally:
        writer.close()
    if cfg.recalibrate_final:
        def calib_ims():
            for _ in range(cfg.recalibrate_final):
                yield prepare(next(batches))["ims"]

        recalibrate_batch_stats(model, calib_ims(), cfg.recalibrate_final)
        print(f"recalibrated BN stats over {cfg.recalibrate_final} batches "
              "before the final save", file=sys.stderr)
    loader.close()
    return logged


def _pretrain_synthetic(cfg: Settings, model, optimizer, ckpt, writer,
                        step0: int) -> dict:
    """The synthetic mode: each step's triplets built and augmented on the
    device from the seed and the global step; a held-out eval MSE at each
    log; the recalibration on unaugmented triplets of their own stream.
    Returns the last logged metrics."""
    from qpwcnet_torch.train import (
        make_interp_train_step,
        recalibrate_batch_stats,
    )

    step = make_interp_train_step(debug_nan=cfg.debug_nan)
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
    try:
        for i in range(step0, cfg.steps):
            batch = _batch(cfg, stream_seed(cfg.seed + 2, i),
                           stream_seed(cfg.seed + 1, i), cfg.augment)
            m = step(model, optimizer, batch)
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
            since += 1
            if (i + 1) % cfg.log_every == 0:
                logged = {k: float(v) / since for k, v in sums.items()}
                logged["mse_eval"] = eval_mse()
                rate = cfg.batch_size * (i + 1 - step0) / (time.time() - t0)
                writer.scalars(i + 1, {**logged, "images_per_sec": rate})
                print(f"step {i + 1}: loss={logged['loss']:.5f} "
                      f"mse_eval={logged['mse_eval']:.5f} "
                      f"({rate:.1f} img/s)", file=sys.stderr, flush=True)
                sums, since = None, 0
            if (i + 1) % cfg.ckpt_every == 0:
                ckpt.save(i + 1, model, optimizer)
    except KeyboardInterrupt:
        print("interrupted; saving", file=sys.stderr)
    finally:
        writer.close()
    if cfg.recalibrate_final:
        def calib_ims():
            for j in range(cfg.recalibrate_final):
                yield _batch(cfg, stream_seed(cfg.seed + 2,
                                              1_000_000_000 + j),
                             0, augment=False)["ims"]

        recalibrate_batch_stats(model, calib_ims(), cfg.recalibrate_final)
        print(f"recalibrated BN stats over {cfg.recalibrate_final} batches "
              "before the final save", file=sys.stderr)
    return logged


def run(cfg: Settings):
    """Pretrain per cfg; returns (model, the last logged metrics as
    floats: synthetic, the mean of each step metric since the previous log
    and 'mse_eval'; the datasets, the step's metrics and
    'loader_wait_ms')."""
    from qpwcnet_torch.train import (
        CheckpointManager,
        MetricWriter,
        create_interp_train_state,
    )
    from qpwcnet_torch.utils.runs import (
        default_root,
        setup_run_dir,
        snapshot_config,
    )

    _check_settings(cfg)
    paths = setup_run_dir(cfg.run_root or default_root("pretrain"))
    snapshot_config(paths["run"], cfg)
    print(f"run dir: {paths['run']}", file=sys.stderr)

    model = build_model(cfg)
    optimizer = create_interp_train_state(model, cfg.learning_rate)
    ckpt = CheckpointManager(paths["ckpt"])
    if cfg.load_ckpt:
        src = CheckpointManager(cfg.load_ckpt)
        src.restore(model, optimizer)
        src.close()
    else:
        ckpt.restore(model, optimizer)  # auto-resume
    step0 = optimizer.global_step
    writer = MetricWriter(paths["log"])
    train = _pretrain_on_dataset if cfg.data != "synthetic" \
        else _pretrain_synthetic
    logged = train(cfg, model, optimizer, ckpt, writer, step0)
    ckpt.save(optimizer.global_step, model, optimizer)
    ckpt.wait()
    return model, logged


@with_args(Settings)
def main(cfg: Settings) -> dict:
    _, metrics = run(cfg)
    print(f"done: {cfg.steps} steps, last logged {metrics}", file=sys.stderr)
    return metrics


if __name__ == "__main__":
    main()
