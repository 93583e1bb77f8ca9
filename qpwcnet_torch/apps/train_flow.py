"""Supervised optical-flow training app (port of
qpwcnet_tpu/apps/train_flow.py).

Each run makes the next run directory under ``--run-root``
(``NNN/{log,ckpt}``, ``config.json``). Data modes:

  * ``synthetic`` (default): each step builds its batch on the device
    (data/synthetic.py) from the seed and the global step index; a
    resolution curriculum (1/4, then 1/2 size) runs first on a fresh run.
  * ``synthetic-uniform``: the host generator (one integer shift a
    sample), batches indexed by the global step (a resumed run replays).
  * ``fc3d`` (``--data-path`` a FlyingThings3D set file, see
    ``apps/data_tools.py fc3d-set``; ``--base-scale 0.56`` as the
    reference) and ``sintel`` (``--data-path`` a TFRecord shard glob, see
    ``data_tools convert``): host threads decode and batch
    (data/pipeline.py:PrefetchLoader, this process's shard of the
    dataset), and each batch is augmented on the device (``--augment
    auto`` is on for them, off for the generators). A resumed run starts
    the dataset again from its first epoch, as JAX's does.

The host-data modes run the step on the data-parallel mesh
(``make_mesh_for_batch``, one process a data shard under
torch.distributed), with the augmentation draws indexed by the global
step. Each step runs the train step (multiscale Huber loss, l2 term,
NaN-grad scrub, [AGC], Adam; train/train_state.py). Every ``log_every``
steps it prints and writes to ``log/metrics.jsonl`` the loss, the EPE,
the EPE with the running BatchNorm statistics (on a held-out batch, or on
the current one in the host-data modes), the predict-zero EPE, images/s
and, in the host-data modes, the ms a step waited on the loader; every
``ckpt_every`` steps, and on an interrupt, it saves a checkpoint. The
BatchNorm statistics are recalibrated (on unaugmented batches) before
the final save.

``--load-ckpt <ckpt dir>`` resumes from that directory's latest
checkpoint (model, optimizer and step): a synthetic run interrupted and
resumed with ``--curriculum ''`` replays the uninterrupted one. With
``--transfer-from-interp true`` it instead copies the encoder, decoder
and flower of a ``pretrain_interp`` checkpoint into the fresh model.

``--qat true`` trains the quantization-aware model (``QuantConfig()``:
fake-quantized convs, activation ranges updated by every train-mode
forward), in every data mode; its checkpoints carry the ranges, and
``--load-ckpt`` of a float run starts a QAT fine-tune from it (ranges
from zero). ``apps/convert_quant.py`` turns a QAT checkpoint into the
int8 bundle.

Run: python -m qpwcnet_torch.apps.train_flow --data synthetic --steps 20
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from qpwcnet_torch.data.synthetic import stream_seed
from qpwcnet_torch.utils.config import with_args

DATA_MODES = ("synthetic", "synthetic-uniform", "fc3d", "sintel")


@dataclasses.dataclass
class Settings:
    """Flow training settings: the fields of the JAX app's Settings that
    the port reads or refuses (not ``steps_per_call``, which fuses steps
    into one dispatch), plus the device."""

    data: str = "synthetic"   # DATA_MODES
    max_disp: float = 24.0    # synthetic flow magnitude bound (px)
    data_path: str = ""       # fc3d set file / sintel shard glob
    batch_size: int = 16
    learning_rate: float = 1e-4
    steps: int = 100_000
    height: int = 256
    width: int = 512
    base_scale: float = 1.0   # 0.56 for FlyingThings3D
    # 'auto': on for the datasets, off for the generators; 'on' / 'off'
    augment: str = "auto"
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
    # quantization-aware training (QuantConfig()); ranges checkpointed
    qat: bool = False
    # BatchNorm recalibration passes at the end of training (0: none).
    recalibrate_final: int = 16
    device: str = "cuda"


def _check_data(cfg: Settings) -> None:
    if cfg.data not in DATA_MODES:
        raise ValueError(f"unknown data source {cfg.data!r}")


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
    """The JAX app's model: build_flow_net with cv_impl='auto' (and
    QuantConfig() under --qat), from cfg.seed (a torch.Generator: other
    initial values than JAX's key)."""
    from qpwcnet_torch.models import build_flow_net
    from qpwcnet_torch.quantize import QuantConfig

    return build_flow_net(cfg.seed, torch.device(cfg.device),
                          dtype=_dtype(cfg), head_scale=cfg.head_scale,
                          residual=cfg.residual,
                          quant=QuantConfig() if cfg.qat else None)


def _batch(cfg: Settings, seed: int, h: int, w: int, disp: float,
           aug_seed=None) -> dict:
    """The synthetic batch of ``seed``, augmented with the draws of
    ``aug_seed`` when it is given."""
    from qpwcnet_torch.data import (
        draw_flow_augmentation,
        preprocess_flow_batch,
        synthetic_flow_batch,
    )

    gen = torch.Generator(device=cfg.device).manual_seed(seed)
    ims_u8, flo = synthetic_flow_batch(gen, cfg.batch_size, h, w,
                                       max_disp=disp)
    draws = None
    if aug_seed is not None:
        gen = torch.Generator(device=cfg.device).manual_seed(aug_seed)
        draws = draw_flow_augmentation(gen, cfg.batch_size, cfg.base_scale)
    return preprocess_flow_batch(ims_u8, flo, (h, w), draws)


def _train(cfg: Settings, model, optimizer, l2_gamma: float,
           steps: range, h: int, w: int, disp: float, stream: tuple,
           tag: str, writer=None, ckpt=None, augment: bool = False) -> dict:
    """The train steps ``steps`` (global indices) at (h, w), step i on
    the batch of ``stream_seed(*stream, i)`` (``augment``: with the
    augmentation draws of ``stream_seed(cfg.seed + 1, i)``); every
    cfg.log_every steps
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
        batch = _batch(cfg, stream_seed(*stream, i), h, w, disp,
                       stream_seed(cfg.seed + 1, i) if augment else None)
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


def _synthetic_batches(cfg: Settings, start_step: int = 0):
    """The host generator (JAX's, draw for draw): smooth textures (4x4
    blocks of uniform noise) shifted by one integer flow a sample
    (prv[p] == nxt[p + flow]), uint8 (B, H, W, 6) and float32 (B, H, W, 2)
    numpy batches. Batch i comes from its own RandomState, so a run
    resumed at step k sees the batches an uninterrupted run saw from k."""
    h, w = cfg.height, cfg.width
    idx = start_step
    while True:
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + idx) % (2**31 - 1))
        idx += 1
        base = rng.uniform(0, 255, (cfg.batch_size, h // 4, w // 4, 3))
        prv = base.repeat(4, axis=1).repeat(4, axis=2)[:, :h, :w]
        prv = prv.astype(np.uint8)
        uv = rng.randint(-8, 9, size=(cfg.batch_size, 2))
        ims = np.empty((cfg.batch_size, h, w, 6), np.uint8)
        flo = np.empty((cfg.batch_size, h, w, 2), np.float32)
        for k in range(cfg.batch_size):
            u, v = int(uv[k, 0]), int(uv[k, 1])
            # prv[i, j] == nxt[i + v, j + u]  =>  nxt = roll(prv, (v, u))
            ims[k, ..., :3] = prv[k]
            ims[k, ..., 3:] = np.roll(prv[k], shift=(v, u), axis=(0, 1))
            flo[k] = uv[k].astype(np.float32)
        yield ims, flo


def _dataset_loader(cfg: Settings, shard_index: int = 0,
                    shard_count: int = 1):
    """The PrefetchLoader of cfg's dataset (JAX's defaults: seed 0,
    shuffled, 4 workers), over this process's shard: 'fc3d' reads the
    pairs of the set file cfg.data_path, 'sintel' every record of the
    shards cfg.data_path matches (a glob, relative or absolute) into
    memory."""
    import glob

    from qpwcnet_torch.data.pipeline import PrefetchLoader, flow_sample_fn

    if cfg.data == "fc3d":
        from qpwcnet_torch.data.fchairs3d import decode_pair, read_set_file

        pairs = read_set_file(cfg.data_path)
        sample, n = flow_sample_fn(pairs, decode_pair), len(pairs)
    elif cfg.data == "sintel":
        from qpwcnet_torch.data.tfrecord import (
            parse_sintel_example,
            tfrecord_iterator,
        )

        records = [r for s in sorted(glob.glob(cfg.data_path))
                   for r in tfrecord_iterator(s)]

        def sample(i):
            return parse_sintel_example(records[i])

        n = len(records)
    else:
        raise ValueError(f"unknown data source {cfg.data!r}")
    return PrefetchLoader(sample, n, cfg.batch_size,
                          shard_index=shard_index, shard_count=shard_count)


def prepare_batch(cfg: Settings, ims_u8, flo, step=None) -> dict:
    """A host batch (numpy uint8 frames, float32 flow) on cfg.device,
    preprocessed there: augmented with the draws of global step ``step``
    (None: resized, unaugmented) at cfg.base_scale."""
    from qpwcnet_torch.data import (
        draw_flow_augmentation,
        preprocess_flow_batch,
    )

    dev = torch.device(cfg.device)
    ims_u8 = torch.from_numpy(ims_u8).to(dev)
    flo = torch.from_numpy(flo).to(dev)
    draws = None
    if step is not None:
        gen = torch.Generator(device=dev).manual_seed(
            stream_seed(cfg.seed + 1, step))
        draws = draw_flow_augmentation(gen, ims_u8.shape[0], cfg.base_scale)
    return preprocess_flow_batch(ims_u8, flo, (cfg.height, cfg.width),
                                 draws)


def _train_on_host_data(cfg: Settings, model, optimizer, ckpt, writer,
                        step0: int) -> dict:
    """The host-data modes: batches from the host generator or this
    process's dataset loader, preprocessed on the device and stepped on
    the data-parallel mesh; then the BatchNorm recalibration on further
    unaugmented batches. Returns the last step's metrics (floats)."""
    from qpwcnet_torch.data import zero_baseline_epe
    from qpwcnet_torch.data.pipeline import prefetch_iterator
    from qpwcnet_torch.parallel import (
        make_mesh_for_batch,
        make_parallel_step,
        process_shard,
        put_batch,
        replicate,
    )
    from qpwcnet_torch.train import (
        epe_error,
        make_flow_train_step,
        recalibrate_batch_stats,
    )

    mesh = make_mesh_for_batch(cfg.batch_size)
    replicate(model, mesh)
    step_fn = make_parallel_step(make_flow_train_step(), mesh)
    loader = None
    if cfg.data == "synthetic-uniform":
        batches = prefetch_iterator(_synthetic_batches(cfg, step0))
    else:
        loader = _dataset_loader(cfg, *process_shard())
        batches = iter(loader)
    augment = cfg.augment == "on" or (
        cfg.augment == "auto" and cfg.data != "synthetic-uniform")
    dev = torch.device(cfg.device)

    def eval_epe(batch) -> dict:
        model.eval()
        with torch.no_grad():
            e = epe_error(batch["flo"], model(batch["ims"]))
        model.train()
        return mesh.mean_over_data({"epe_eval": e,
                                    "epe_zero": zero_baseline_epe(
                                        batch["flo"])})

    metrics, waited = {}, 0.0
    t0 = time.time()
    try:
        for i in range(step0, cfg.steps):
            t_wait = time.perf_counter()
            ims_u8, flo = next(batches)
            waited += time.perf_counter() - t_wait
            batch = put_batch(prepare_batch(cfg, ims_u8, flo,
                                            i if augment else None),
                              mesh, dev)
            metrics = step_fn(model, optimizer, batch)
            if (i + 1) % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update({k: float(v) for k, v in eval_epe(batch).items()})
                m["loader_wait_ms"] = 1e3 * waited / cfg.log_every
                waited = 0.0
                rate = cfg.batch_size * (i + 1 - step0) / (time.time() - t0)
                writer.scalars(i + 1, {**m, "images_per_sec": rate})
                print(f"step {i + 1}: loss={m['loss']:.4f} "
                      f"epe={m['epe']:.3f} epe_eval={m['epe_eval']:.3f} "
                      f"epe_zero={m['epe_zero']:.3f} ({rate:.1f} img/s, "
                      f"loader wait {m['loader_wait_ms']:.1f} ms a step)",
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
                yield prepare_batch(cfg, *next(batches))["ims"]

        recalibrate_batch_stats(model, calib_ims(), cfg.recalibrate_final)
        print(f"recalibrated BN stats over {cfg.recalibrate_final} batches "
              "before the final save", file=sys.stderr)
    if loader is not None:
        loader.close()
    return {k: float(v) for k, v in metrics.items()}


def run(cfg: Settings):
    """Train per cfg; returns (model, the last step's metrics)."""
    from qpwcnet_torch.train import CheckpointManager, MetricWriter
    from qpwcnet_torch.utils.runs import setup_run_dir, snapshot_config

    _check_data(cfg)
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
    writer = MetricWriter(paths["log"])
    if cfg.data != "synthetic":
        metrics = _train_on_host_data(cfg, model, optimizer, ckpt, writer,
                                      step0)
    else:
        if cfg.curriculum and step0 == 0 and not cfg.load_ckpt:
            _curriculum(cfg, model, optimizer, kind, l2_gamma)
        metrics = {}
        try:
            # 'auto' is off for the generator
            metrics = _train(cfg, model, optimizer, l2_gamma,
                             range(step0, cfg.steps), cfg.height, cfg.width,
                             cfg.max_disp, (cfg.seed + 2,), "", writer, ckpt,
                             augment=cfg.augment == "on")
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
