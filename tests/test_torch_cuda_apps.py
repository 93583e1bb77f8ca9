"""The port's apps and the paths around the models on a CUDA card:

  * checkpoints: the round trip, resumed train_flow and pretrain_interp
    runs bit-equal to uninterrupted ones, the weight handover, eval_sintel
    on a 436x1024 Sintel-layout fixture, the inference apps with
    --load-ckpt;
  * the dataset paths on fixtures at each dataset's own layout and frame
    size (FlyingThings3D, Sintel, Vimeo-90K, YouTube-VOS): the flow
    augmentation on the card against the CPU, the apps' dataset modes,
    data_tools;
  * quantization: the QAT steps against the plain QAT models, int8
    inference at 448x1024 b8 against the plain int8 models, the QAT apps
    resumed bit-equal, convert_quant;
  * the last slice: show_network's launches, trace and flops,
    pretrain_interp --debug-nan, the int8 forward in 2 H shards,
    convert_quant --export's programs, the last ops and losses on the
    card against the CPU.

Every run of an app is a main path: its exact K1-K5 launches and its bias
+ Mish launches (``main_path``). Every test but the dataset paths' runs
with cuDNN's deterministic algorithms. Each test is marked ``cuda`` and
skips without a card; the file imports neither jax nor the JAX package
(run as tests/test_torch_cuda.py says).
"""

import contextlib
import dataclasses
import io
import json
import re

import numpy as np
import pytest
import torch

from qpwcnet_torch.ops import cuda as kernels
from test_torch_cuda import (
    B,
    CV_LEVELS,
    H,
    SPATIAL_N_FWD,
    TRAIN_B,
    TRAIN_H,
    TRAIN_LEVELS,
    TRAIN_W,
    W,
)
from test_torch_cuda_models import (  # noqa: F401  (fixtures)
    BF16,
    F32,
    INTERP_B,
    SEED,
    SPATIAL_HALO_FWD,
    batch,
    build,
    build_interp,
    build_train,
    compare_grads,
    compare_model,
    counts_of,
    cudnn_deterministic,
    deterministic,
    dev,
    epilogue_ran,
    grad_step,
    ibatch,
    k_only,
    launches,
    main_path,
    spatial_counts,
    x,
)


# ------------------------------------------------------------ checkpoints

def state_diff(a, b) -> list:
    """The leaves in which two checkpoints (torch.load of state.pt) or
    two (model, chain) pairs' states differ: the step, every state_dict
    entry and every Adam step/exp_avg/exp_avg_sq, compared on the host
    bit for bit."""
    diff = [] if a["step"] == b["step"] else ["step"]
    if a["model"].keys() != b["model"].keys():
        return diff + ["model keys"]
    diff += [k for k in a["model"]
             if not torch.equal(a["model"][k].cpu(), b["model"][k].cpu())]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    if sa.keys() != sb.keys() or not sa:
        return diff + ["Adam state keys"]
    diff += [f"adam.{i}.{n}" for i in sa
             for n in ("step", "exp_avg", "exp_avg_sq")
             if not torch.equal(sa[i][n].cpu(), sb[i][n].cpu())]
    return diff


def live_state(model, chain) -> dict:
    """A (model, GradientChain) pair in the layout of a checkpoint."""
    return {"step": chain.global_step, "model": model.state_dict(),
            "optimizer": chain.state_dict()}


def load_ckpt(ckpt_dir, step) -> dict:
    return torch.load(ckpt_dir / str(step) / "state.pt", map_location="cpu",
                      weights_only=True)


def write_sintel_fixture(root, dev, seed, h=436, w=1024, disp=8.0,
                         n_frames=3) -> None:
    """A Sintel-layout tree: one sequence of n_frames frames at h x w of a
    warped synthetic texture (frame_k = warp(frame_k+1, flow_k)) and its
    n_frames - 1 .flo files, written by the port's own PNG and .flo
    writers."""
    from qpwcnet_torch.data.flo_format import write_flo
    from qpwcnet_torch.data.synthetic import random_flow_field, random_texture
    from qpwcnet_torch.ops.warp import backward_warp
    from qpwcnet_torch.vis import write_png

    gen = torch.Generator(device=dev).manual_seed(seed)
    pad = int(2 * disp + 1)
    hp, wp = h + 2 * pad, w + 2 * pad
    frames = [random_texture(gen, 1, hp, wp)]
    flows = []
    for _ in range(n_frames - 1):
        flows.insert(0, random_flow_field(gen, 1, hp, wp, max_disp=disp))
        frames.insert(0, backward_warp(frames[0], flows[0]))
    img_dir = root / "training" / "final" / "seq"
    flo_dir = root / "training" / "flow" / "seq"
    img_dir.mkdir(parents=True)
    flo_dir.mkdir(parents=True)
    crop = (0, slice(pad, pad + h), slice(pad, pad + w))
    for i, f in enumerate(frames):
        rgb = torch.clamp(torch.round(f[crop] * 255.0), 0, 255)
        write_png(img_dir / f"frame_{i + 1:04d}.png",
                  rgb.to(torch.uint8).cpu().numpy())
    for i, fl in enumerate(flows):
        write_flo(flo_dir / f"frame_{i + 1:04d}.flo",
                  fl[crop].cpu().numpy().astype(np.float32))


def resumed_runs(app, root, args) -> dict:
    """Run A (4 steps), run B (2 steps) and run C (B resumed to 4) of an
    app under ``root`` (run directories 000, 001, 002), under cuDNN's
    deterministic algorithms; returns the three runs' launches."""
    with cudnn_deterministic():
        _, counts = launches(lambda: [
            app.main(args + ["--steps", "4"]),
            app.main(args + ["--steps", "2"]),
            app.main(args + ["--steps", "4", "--load-ckpt",
                             str(root / "001" / "ckpt")])])
    return counts


# 4 + 2 + 2 steps; a forward in each, and a held-out one each 2 steps
RESUME_STEPS, RESUME_FWD = 8, 12


@pytest.fixture(scope="module")
def flow_runs(dev, tmp_path_factory):
    """train_flow (bf16, b16) A / B / C: the run root and the launches."""
    from qpwcnet_torch.apps import train_flow

    root = tmp_path_factory.mktemp("flow")
    return root, resumed_runs(train_flow, root, [
        "--data", "synthetic", "--curriculum", "", "--batch-size",
        str(TRAIN_B), "--height", str(TRAIN_H), "--width", str(TRAIN_W),
        "--compute-dtype", "bfloat16", "--recalibrate-final", "0",
        "--log-every", "2", "--ckpt-every", "2", "--device", str(dev),
        "--run-root", str(root)])


@pytest.fixture(scope="module")
def pretrain_runs(dev, tmp_path_factory):
    """pretrain_interp (bf16, b8, augmentation on) A / B / C."""
    from qpwcnet_torch.apps import pretrain_interp

    root = tmp_path_factory.mktemp("pre")
    return root, resumed_runs(pretrain_interp, root, [
        "--batch-size", str(INTERP_B), "--height", str(TRAIN_H), "--width",
        str(TRAIN_W), "--compute-dtype", "bfloat16", "--recalibrate-final",
        "0", "--log-every", "2", "--ckpt-every", "2", "--device", str(dev),
        "--run-root", str(root)])


@pytest.mark.cuda
def test_checkpoint_round_trip(dev, batch, tmp_path, deterministic):
    """The 256x512 b16 bf16 flow model after two steps saved, restored on
    the card and onto a CPU model: step, every leaf and the Adam state
    bit-equal, and the restored model's forward bit-equal."""
    from qpwcnet_torch.models import build_flow_net
    from qpwcnet_torch.train import (
        CheckpointManager, make_flow_train_step, plain_optimizer)

    model = build_train(BF16, dev, cv_impl="auto", stem_stages=2)
    opt = plain_optimizer(model, 1e-4)
    step = make_flow_train_step()
    for _ in range(2):
        step(model, opt, batch)
    mgr = CheckpointManager(tmp_path)
    assert mgr.save(2, model, opt), "save refused"
    fresh = build_train(BF16, dev, k=0.0, cv_impl="auto", stem_stages=2)
    chain = plain_optimizer(fresh, 1e-4)
    cpu = build_flow_net(SEED + 1, "cpu", dtype=BF16, cv_impl="auto",
                         stem_stages=2)
    cpu_chain = plain_optimizer(cpu, 1e-4)
    assert mgr.restore(fresh, chain) == mgr.restore(cpu, cpu_chain) == 2
    want = live_state(model, opt)
    assert not state_diff(want, live_state(fresh, chain))
    assert not state_diff(want, live_state(cpu, cpu_chain))
    model.eval()
    fresh.eval()
    with torch.inference_mode():
        assert torch.equal(model(batch["ims"]), fresh(batch["ims"]))


@pytest.mark.cuda
def test_train_flow_resume_is_bit_equal(flow_runs):
    """C's final checkpoint equals A's; the runs' checkpoints are at the
    steps they ran to; the three runs are a main path (K1 in every
    forward, K4a and K4b in every step)."""
    from qpwcnet_torch.train import CheckpointManager

    root, counts = flow_runs
    steps = [CheckpointManager(root / f"00{r}" / "ckpt").all_steps()
             for r in range(3)]
    assert steps == [[2, 4], [2], [4]], steps
    diff = state_diff(load_ckpt(root / "000" / "ckpt", 4),
                      load_ckpt(root / "002" / "ckpt", 4))
    assert not diff, diff
    main_path(counts, K1=5 * RESUME_FWD, K4a=5 * RESUME_STEPS,
              K4b=5 * RESUME_STEPS)


@pytest.mark.cuda
def test_pretrain_interp_resume_is_bit_equal(pretrain_runs):
    root, counts = pretrain_runs
    diff = state_diff(load_ckpt(root / "000" / "ckpt", 4),
                      load_ckpt(root / "002" / "ckpt", 4))
    assert not diff, diff
    main_path(counts, K1=5 * RESUME_FWD, K4a=5 * RESUME_STEPS,
              K4b=5 * RESUME_STEPS)


@pytest.mark.cuda
def test_transfer_from_interp(dev, pretrain_runs, tmp_path, deterministic):
    """train_flow --transfer-from-interp from the pretraining checkpoint:
    --steps 0 keeps the state before the first step, holding every shared
    parameter of the interpolator's; --steps 2 is a main path (its
    curriculum is skipped)."""
    from qpwcnet_torch.apps import train_flow

    pre_ckpt = pretrain_runs[0] / "000" / "ckpt"
    xargs = ["--data", "synthetic", "--curriculum", "1,1", "--batch-size",
             str(TRAIN_B), "--height", str(TRAIN_H), "--width",
             str(TRAIN_W), "--compute-dtype", "bfloat16",
             "--recalibrate-final", "0", "--log-every", "2", "--ckpt-every",
             "2", "--device", str(dev), "--load-ckpt", str(pre_ckpt),
             "--transfer-from-interp", "true", "--run-root", str(tmp_path)]
    train_flow.main(xargs + ["--steps", "0"])
    src = load_ckpt(pre_ckpt, 4)["model"]
    dst = load_ckpt(tmp_path / "000" / "ckpt", 0)["model"]
    shared = [k for k in dst if k.split(".")[0] in
              ("encoder", "decoder", "flower")
              and not k.endswith(("running_mean", "running_var",
                                  "num_batches_tracked"))]
    differ = [k for k in shared if not torch.equal(dst[k], src[k])]
    assert len(shared) > 100 and not differ, differ
    metrics, counts = launches(lambda: train_flow.main(xargs
                                                       + ["--steps", "2"]))
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    main_path(counts, K1=5 * 3, K4a=10, K4b=10)


@pytest.mark.cuda
def test_eval_sintel(dev, flow_runs, tmp_path, deterministic):
    """eval_sintel on a 436x1024 Sintel-layout fixture, a main path: run
    A's checkpoint with 'pad' and 'resize' after recalibration; a
    checkpoint of the float32 flow net with seeded heads (flows of ~2 px
    in eval mode; run A's 4 steps leave them near 0, and the EPE then
    near predict-zero's) without it, the card within a relative 1e-4 of
    the CPU and the EPE off predict-zero's by 100 times that."""
    from qpwcnet_torch.apps import eval_sintel
    from qpwcnet_torch.data.flo_format import read_flo
    from qpwcnet_torch.train import CheckpointManager, plain_optimizer
    from qpwcnet_torch.utils.config import parse_config

    write_sintel_fixture(tmp_path / "sintel", dev, SEED + 20)

    def evaluate(ckpt, *extra):
        return eval_sintel.run(parse_config(eval_sintel.Settings, [
            "--data-path", str(tmp_path / "sintel"), "--load-ckpt",
            str(ckpt), *extra]))

    seeded = build(F32, dev)
    CheckpointManager(tmp_path / "seeded").save(
        0, seeded, plain_optimizer(seeded, 0.0))
    del seeded
    flow_ckpt = flow_runs[0] / "000" / "ckpt"
    (pad, resize, card), counts = launches(lambda: [
        evaluate(flow_ckpt, "--protocol", "pad", "--recalibrate", "2",
                 "--device", str(dev)),
        evaluate(flow_ckpt, "--protocol", "resize", "--recalibrate", "2",
                 "--device", str(dev)),
        evaluate(tmp_path / "seeded", "--recalibrate", "0", "--device",
                 str(dev))])
    on_cpu = evaluate(tmp_path / "seeded", "--recalibrate", "0", "--device",
                      "cpu")
    for r in (pad, resize, card, on_cpu):
        assert r["n"] == 2 and np.isfinite(r["value"]), r
    rel = abs(card["value"] - on_cpu["value"]) / abs(on_cpu["value"])
    assert rel <= 1e-4, rel
    zero = float(np.mean([
        np.linalg.norm(read_flo(f), axis=-1).mean() for f in
        sorted((tmp_path / "sintel" / "training" / "flow").rglob("*.flo"))]))
    assert abs(card["value"] - zero) > 1e-2 * zero, (card, zero)
    # float32 K1, 448x1024 b1: 2 recalibration and 2 eval forwards in each
    # of the first two runs, 2 eval forwards in the third
    main_path(counts, K1=5 * 10)


@pytest.mark.cuda
def test_infer_load_ckpt(dev, flow_runs, tmp_path, deterministic):
    """infer --fast --load-ckpt at 448x1024, a main path: every leaf is
    the checkpoint's, finite warp-validation errors."""
    from qpwcnet_torch.apps import infer
    from qpwcnet_torch.utils.config import parse_config

    flow_ckpt = flow_runs[0] / "000" / "ckpt"
    cfg = parse_config(infer.Settings, [
        "--fast", "true", "--n", "2", "--height", str(H), "--width", str(W),
        "--out-dir", str(tmp_path), "--device", str(dev), "--load-ckpt",
        str(flow_ckpt)])
    model = infer.build_model(cfg)
    saved = load_ckpt(flow_ckpt, 4)["model"]
    loaded = [k for k, v in model.state_dict().items()
              if not torch.equal(v.cpu(), saved[k])]
    assert not loaded, loaded
    errs, counts = launches(lambda: infer.run(cfg, model))
    assert len(errs) == 2 and all(np.isfinite(errs)), errs
    main_path(counts, K1=8, K2=4, K3=2)


@pytest.mark.cuda
def test_interp_infer_load_ckpt(dev, pretrain_runs, tmp_path,
                                deterministic):
    from qpwcnet_torch.apps import interp_infer

    results, counts = launches(lambda: interp_infer.main([
        "--data", "synthetic", "--n", "2", "--height", str(TRAIN_H),
        "--width", str(TRAIN_W), "--out-dir", str(tmp_path), "--device",
        str(dev), "--load-ckpt", str(pretrain_runs[0] / "000" / "ckpt")]))
    assert len(results) == 2 and all(np.isfinite(r["psnr"])
                                     for r in results), results
    main_path(counts, K1=10)


# ------------------------------------------------------- dataset paths

DATA_B, DATA_STEPS, DATA_LOG, DATA_RECAL = 16, 4, 2, 2
FT3D_HW, SINTEL_HW, VIMEO_HW, YTVOS_HW = (540, 960), (436, 1024), \
    (256, 448), (720, 1280)
FT3D_NAN_FRAME = 3


def write_pfm(path, arr) -> None:
    """A little-endian 3-channel PFM of arr (H, W, 3) float32 (rows
    stored bottom-up)."""
    h, w = arr.shape[:2]
    path.write_bytes(f"PF\n{w} {h}\n-1.0\n".encode()
                     + np.flipud(arr).astype("<f4").tobytes())


def frames_u8(gen, n, h, w):
    """n textures (H, W, 3) as host uint8 arrays, made on the card."""
    from qpwcnet_torch.data.synthetic import random_texture

    t = random_texture(gen, n, h, w)
    return torch.clamp(torch.round(t * 255.0), 0, 255).to(
        torch.uint8).cpu().numpy()


@pytest.fixture(scope="module")
def data(dev, tmp_path_factory) -> dict:
    """The four datasets in their own layouts and frame sizes, each at
    least one batch: FlyingThings3D (17 WebP frames at 540x960 and their
    PFM flows, NaN pixels in one), Sintel (17 frames at 436x1024,
    converted by data_tools to 2 TFRecord shards), Vimeo-90K (8 train and
    2 test triplets of 256x448 PNGs) and YouTube-VOS (8 train videos of 5
    720x1280 JPEGs). The data paths by mode, and the root."""
    from PIL import Image

    from qpwcnet_torch.apps import data_tools
    from qpwcnet_torch.data.synthetic import random_flow_field
    from qpwcnet_torch.vis import write_png

    root = tmp_path_factory.mktemp("data")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    h, w = FT3D_HW
    left = root / "f3d" / "frames_finalpass_webp" / "TRAIN" / "A" / \
        "0000" / "left"
    flo_dir = root / "f3d" / "optical_flow" / "TRAIN" / "A" / "0000" / \
        "into_future" / "left"
    left.mkdir(parents=True)
    flo_dir.mkdir(parents=True)
    for k, img in enumerate(frames_u8(gen, DATA_B + 1, h, w)):
        Image.fromarray(img).save(left / f"{6 + k:04d}.webp", quality=90)
        flo = random_flow_field(gen, 1, h, w, max_disp=24.0)[0].cpu().numpy()
        flo = np.concatenate([flo, np.zeros((h, w, 1), np.float32)], -1)
        if k == FT3D_NAN_FRAME:
            flo[h // 5:h // 5 + 4, w // 5:w // 5 + 10, 0] = np.nan
        write_pfm(flo_dir / f"OpticalFlowIntoFuture_{6 + k:04d}_L.pfm", flo)
    data_tools.main(["fc3d-set", "--root", str(root / "f3d"), "--out",
                     str(root / "f3d_set.txt")])

    write_sintel_fixture(root / "sintel", dev, SEED + 31, *SINTEL_HW,
                         n_frames=DATA_B + 1)
    data_tools.main(["convert", "--root", str(root / "sintel"), "--out",
                     str(root / "shards"), "--shards", "2"])

    vimeo = root / "vimeo"
    keys = [f"{i // 4 + 1:05d}/{i % 4 + 1:04d}" for i in range(10)]
    frames = frames_u8(gen, 3 * len(keys), *VIMEO_HW)
    for i, key in enumerate(keys):
        d = vimeo / "sequences" / key
        d.mkdir(parents=True)
        for j in range(3):
            write_png(d / f"im{j + 1}.png", frames[3 * i + j])
    (vimeo / "tri_trainlist.txt").write_text("\n".join(keys[:8]) + "\n")
    (vimeo / "tri_testlist.txt").write_text("\n".join(keys[8:]) + "\n")

    for v in range(8):
        d = root / "ytvos" / "train" / "JPEGImages" / f"v{v:03d}"
        d.mkdir(parents=True)
        for k, img in enumerate(frames_u8(gen, 5, *YTVOS_HW)):
            Image.fromarray(img).save(d / f"{5 * k:05d}.jpg", quality=90)
    return {"fc3d": str(root / "f3d_set.txt"),
            "sintel": str(root / "shards" / "*.tfrecord"),
            "vimeo": str(vimeo), "ytvos": str(root / "ytvos"), "dummy": "",
            "synthetic-uniform": "", "root": root}


@pytest.mark.cuda
def test_pil_decodes_the_datasets(dev):
    """PIL decodes WebP (FlyingThings3D), JPEG (YouTube-VOS) and PNG."""
    from PIL import features

    codecs = {c: features.check(c) for c in ("webp", "jpg", "zlib")}
    assert all(codecs.values()), codecs


@pytest.mark.cuda
@pytest.mark.parametrize("mode,base_scale", [("sintel", 1.0),
                                             ("fc3d", 0.56)])
def test_augmentation_card_matches_cpu(dev, data, mode, base_scale):
    """preprocess_flow_batch with the same draws (made on the CPU) on the
    card and on the CPU, on a decoded batch of the dataset (b16 ->
    256x512): images within 1e-5, flows within 1e-4 px, and each sample's
    flow channel that holds a NaN all 0 on both."""
    from qpwcnet_torch.apps import train_flow
    from qpwcnet_torch.data import (
        draw_flow_augmentation, preprocess_flow_batch)
    from qpwcnet_torch.utils.config import parse_config

    loader = train_flow._dataset_loader(parse_config(train_flow.Settings, [
        "--data", mode, "--data-path", data[mode], "--batch-size",
        str(DATA_B)]))
    ims_u8, flo = next(iter(loader))
    loader.close()
    draws = draw_flow_augmentation(torch.Generator().manual_seed(SEED + 31),
                                   ims_u8.shape[0], base_scale)
    out = (TRAIN_H, TRAIN_W)
    cpu = preprocess_flow_batch(torch.from_numpy(ims_u8),
                                torch.from_numpy(flo), out, draws)
    card = preprocess_flow_batch(
        torch.from_numpy(ims_u8).to(dev), torch.from_numpy(flo).to(dev),
        out, {k: v.to(dev) for k, v in draws.items()})
    torch.cuda.synchronize()
    assert bool(torch.isfinite(card["ims"]).all()
                and torch.isfinite(card["flo"]).all())
    assert float((card["ims"].cpu() - cpu["ims"]).abs().max()) <= 1e-5
    assert float((card["flo"].cpu() - cpu["flo"]).abs().max()) <= 1e-4
    nan = np.argwhere(np.isnan(flo).any(axis=(1, 2)))
    assert all(bool((o["flo"][b, ..., c] == 0).all()) for b, c in nan
               for o in (cpu, card))


def dataset_run(app, data, mode, batch_size, run_root, dev, monkeypatch):
    """One app run on a dataset mode (256x512 bf16, DATA_STEPS steps),
    the YouTube-VOS index cached under the data root: its last metrics,
    whether it saved its last checkpoint, and its launches."""
    monkeypatch.setenv("QPWCNET_TORCH_CACHE", str(data["root"] / "cache"))
    m, counts = launches(lambda: app.main([
        "--steps", str(DATA_STEPS), "--height", str(TRAIN_H), "--width",
        str(TRAIN_W), "--compute-dtype", "bfloat16", "--log-every",
        str(DATA_LOG), "--recalibrate-final", str(DATA_RECAL), "--device",
        str(dev), "--data", mode, "--data-path", data[mode],
        "--batch-size", str(batch_size), "--run-root", str(run_root)]
        + (["--base-scale", "0.56"] if mode == "fc3d" else [])))
    saved = (run_root / "000" / "ckpt" / str(DATA_STEPS) /
             "state.pt").exists()
    return m, saved, counts


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fc3d", "sintel", "synthetic-uniform"])
def test_train_flow_dataset_modes(dev, data, mode, tmp_path, monkeypatch):
    """train_flow --data <mode> (b16, augmentation on for the datasets),
    a main path: finite metrics and a checkpoint."""
    from qpwcnet_torch.apps import train_flow

    m, saved, counts = dataset_run(train_flow, data, mode, TRAIN_B,
                                   tmp_path, dev, monkeypatch)
    assert all(np.isfinite(v) for v in m.values()) and saved, m
    n_fwd = DATA_STEPS + DATA_STEPS // DATA_LOG + DATA_RECAL
    main_path(counts, K1=5 * n_fwd, K4a=5 * DATA_STEPS, K4b=5 * DATA_STEPS)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["vimeo", "ytvos", "dummy"])
def test_pretrain_interp_dataset_modes(dev, data, mode, tmp_path,
                                       monkeypatch):
    from qpwcnet_torch.apps import pretrain_interp

    m, saved, counts = dataset_run(pretrain_interp, data, mode, INTERP_B,
                                   tmp_path, dev, monkeypatch)
    assert np.isfinite(m["loss"]) and saved, m
    main_path(counts, K1=5 * (DATA_STEPS + DATA_RECAL), K4a=5 * DATA_STEPS,
              K4b=5 * DATA_STEPS)


@pytest.mark.cuda
def test_interp_infer_vimeo(dev, data, tmp_path):
    """interp_infer --data vimeo, a main path: finite PSNRs, 14 PNGs."""
    from qpwcnet_torch.apps import interp_infer

    results, counts = launches(lambda: interp_infer.main([
        "--data", "vimeo", "--data-path", data["vimeo"], "--n", "2",
        "--height", str(TRAIN_H), "--width", str(TRAIN_W), "--out-dir",
        str(tmp_path), "--device", str(dev)]))
    assert len(results) == 2 and all(np.isfinite(r["psnr"])
                                     for r in results), results
    assert len(list(tmp_path.glob("*.png"))) == 14
    main_path(counts, K1=10)


@pytest.mark.cuda
def test_data_tools(dev, data, tmp_path):
    """data_tools stats and nan-scan (the NaN sample reported) on the
    fixtures that fc3d-set and convert made, and preview."""
    from qpwcnet_torch.apps import data_tools

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        data_tools.main(["stats", "--shards", data["sintel"]])
        data_tools.main(["nan-scan", "--set-file", data["fc3d"]])
    data_tools.main(["preview", "--shards", data["sintel"], "--out",
                     str(tmp_path / "preview.png"), "--device", str(dev)])
    said = out.getvalue().splitlines()
    assert said[0].startswith(f"n={DATA_B} "), said
    assert said[1] == f"1/{DATA_B} samples contain NaNs", said
    assert (tmp_path / "preview.png").stat().st_size > 0


# --------------------------------------------------------- quantization

# int8 codes a kernel may flip at a chained conv (1%), and that the
# H-sharded forward may (0.1%)
QUANT_FLIP_SHARE, SHARDED_FLIP_SHARE = 0.01, 1e-3
# the finest flow head's first chained conv
CHAINED = "flower.upflows.3.flow.of_feats.0.pointwise"


def int8():
    from qpwcnet_torch.quantize import QuantConfig

    return dataclasses.replace(QuantConfig(), mode="int8")


@contextlib.contextmanager
def plain_fused_warp():
    """K3's wrapper swapped for its plain version on card tensors (the
    Functions look the wrapper up at call time): the reference of the
    int8 'fast' model, whose finest level computes the window warp."""
    from qpwcnet_torch.ops.cuda import warp_cv_kernel as k3

    saved = k3.warp_cost_volume_cuda
    k3.warp_cost_volume_cuda = k3.warp_cost_volume_plain
    try:
        yield
    finally:
        k3.warp_cost_volume_cuda = saved


def ranges_of(model) -> dict:
    from qpwcnet_torch.quantize.qlayers import quant_ranges

    return {k: b.detach().clone() for k, b in quant_ranges(model).items()}


def range_err(got, want) -> float:
    """The largest |got - want| of any range vector over its largest
    channel."""
    return max(float((got[k] - w).abs().max()) / max(float(w.max()), 1e-30)
               for k, w in want.items())


def int8_calibrated(dev, x):
    """The bf16 QAT flow model with ranges from two train-mode forwards
    on x's halves (a batch of 1: on x twice)."""
    from qpwcnet_torch.quantize import QuantConfig

    calib = build(BF16, dev, cv_impl="auto", quant=QuantConfig()).train()
    half = x.shape[0] // 2
    with torch.inference_mode():
        for part in ((x[:half], x[half:]) if half else (x, x)):
            calib(part)
    return calib.eval()


def int8_flow(dev, cv_impl, calib, **kw):
    """A bf16 PWCFlowNet in int8 mode with the seeded heads and the
    ranges (and BatchNorm statistics) of ``calib``."""
    m = build(BF16, dev, cv_impl=cv_impl, quant=int8(), **kw)
    m.load_state_dict(calib.state_dict())
    return m


def emitted(model, store: list):
    """A hook keeping the int8 codes of the QTensor that CHAINED emits;
    returns its handle."""
    return model.get_submodule(CHAINED).register_forward_hook(
        lambda mod, inp, out: store.append(out.q))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["flow", "pretraining"])
def test_qat_step_matches_plain(dev, batch, ibatch, path, deterministic):
    """One QAT step (learning rate 0) of the plain model in float32 and
    bf16 and of the kernel model in bf16 (the flow step at 256x512 b16,
    the pretraining step at b8), a main path: the loss within 2x the
    plain bf16 step's distance from the float32 one, every gradient (the
    bf16 rule of compare_grads), and the ranges the step's forward set
    (within 2x the plain bf16 step's own distance from the float32 one,
    plus 1e-6 of the range)."""
    from qpwcnet_torch.quantize import QuantConfig
    from qpwcnet_torch.train import make_interp_train_step

    if path == "flow":
        def build_fn(dt, cv):
            return build_train(dt, dev, cv_impl=cv, quant=QuantConfig())
        data, make_step = batch, None
    else:
        def build_fn(dt, cv):
            return build_interp(dt, dev, k=1.5, cv_impl=cv,
                                quant=QuantConfig())
        data, make_step = ibatch, make_interp_train_step
    res = {}
    for mode, dtype, cv in (("plain", F32, "plain"), ("plain", BF16, "plain"),
                            ("kernel", BF16, "auto")):
        m = build_fn(dtype, cv)
        loss, grads, counts = grad_step(m, data, make_step,
                                        plain=mode == "plain")
        if mode == "plain":
            assert k_only(counts) == counts_of(), counts
        else:
            main_path(counts, K1=5, K4a=5, K4b=5)
        res[mode, dtype] = (loss, grads, ranges_of(m))
        del m
        torch.cuda.empty_cache()
    (l32, g32, r32), (lp, gp, rp), (lk, gk, rk) = (
        res["plain", F32], res["plain", BF16], res["kernel", BF16])
    assert min(float(r.max()) for r in rk.values()) > 0.0
    assert abs(lk - lp) <= 2.0 * abs(lp - l32) + 1e-6 * abs(lp), (lk, lp,
                                                                  l32)
    compare_grads(gk, gp, g32)
    e, n = range_err(rk, rp), range_err(rp, r32)
    assert e <= 2.0 * n + 1e-6, (e, n)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_int8_forward_matches_plain(dev, x, mode, deterministic):
    """int8 inference at 448x1024 b8 bf16 (ranges from two QAT train-mode
    forwards on the batch's halves), a main path (exact: K1 5; 'fast': K1
    4, K3 1) against the plain int8 model (cv_impl='plain'; 'fast' also
    K3's plain version), which launches no kernel: phase 4's bf16 model
    bound, and at most 1% of the finest head's first chained conv's
    emitted codes flipped."""
    calib = int8_calibrated(dev, x)
    codes = []
    with torch.inference_mode():
        with plain_fused_warp():
            ref = int8_flow(dev, "plain" if mode == "exact"
                            else ("plain",) * 4 + ("fused",), calib)
            hook = emitted(ref, codes)
            want, counts = launches(lambda: ref(x))
            hook.remove()
        assert k_only(counts) == counts_of(), counts
        got_m = int8_flow(dev, "auto" if mode == "exact" else "fast", calib)
        hook = emitted(got_m, codes)
        got, counts = launches(lambda: got_m(x))
        hook.remove()
    main_path(counts, **(dict(K1=5) if mode == "exact" else dict(K1=4, K3=1)))
    compare_model(got, want, BF16)
    d = (codes[1].int() - codes[0].int()).abs()
    assert int((d > 0).sum()) <= QUANT_FLIP_SHARE * d.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("app_name,b", [("train_flow", TRAIN_B),
                                        ("pretrain_interp", INTERP_B)])
def test_qat_apps_resume_bit_equal(dev, app_name, b, tmp_path,
                                   deterministic):
    """<app> --qat, A 2 steps, B 1, C B resumed to 2 (bf16): C's
    checkpoint equals A's, the ranges included; a main path (each step and
    each log's held-out forward run K1)."""
    import importlib

    app = importlib.import_module(f"qpwcnet_torch.apps.{app_name}")
    extra = (["--data", "synthetic", "--curriculum", ""]
             if app_name == "train_flow" else [])
    args = extra + [
        "--qat", "true", "--batch-size", str(b), "--height", str(TRAIN_H),
        "--width", str(TRAIN_W), "--compute-dtype", "bfloat16",
        "--recalibrate-final", "0", "--log-every", "1", "--ckpt-every", "1",
        "--device", str(dev), "--run-root", str(tmp_path)]
    _, counts = launches(lambda: [
        app.main(args + ["--steps", "2"]), app.main(args + ["--steps", "1"]),
        app.main(args + ["--steps", "2", "--load-ckpt",
                         str(tmp_path / "001" / "ckpt")])])
    a = load_ckpt(tmp_path / "000" / "ckpt", 2)
    diff = state_diff(a, load_ckpt(tmp_path / "002" / "ckpt", 2))
    assert sum("amax" in k for k in a["model"]) >= 118 and not diff, diff
    main_path(counts, K1=5 * 8, K4a=5 * 4, K4b=5 * 4)


@pytest.mark.cuda
def test_convert_quant(dev, tmp_path, deterministic):
    """convert_quant --steps 3 --check true at 256x512, a main path (3
    calibration steps, then the int8 and float forwards): 69 convs, a
    finite check, the bundle loads back equal."""
    from qpwcnet_torch.apps import convert_quant
    from qpwcnet_torch.quantize import load_int8_bundle

    out = tmp_path / "int8.npz"
    res, counts = launches(lambda: convert_quant.run(dataclasses.replace(
        convert_quant.Settings(), steps=3, height=TRAIN_H, width=TRAIN_W,
        out=str(out), device=str(dev))))
    loaded = load_int8_bundle(out)
    assert list(loaded) == list(res["int8"]) and all(
        np.array_equal(getattr(loaded[k], f), getattr(res["int8"][k], f))
        for k in loaded for f in ("kernel_i8", "w_scale", "in_amax")
        if getattr(loaded[k], f) is not None)
    assert res["n_convs"] == 69 and np.isfinite(res["check_pct"]), res
    main_path(counts, K1=25, K4a=15, K4b=15)


# ------------------------------------------------------- the last slice

def k1_flops(levels, batch) -> int:
    """K1's registered flop formula (2·81·C a pixel) summed over one
    forward's five cost volumes, ``batch`` images a level."""
    return sum(2 * 81 * c * batch * h * w for h, w, c in levels)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["flow", "interp"])
def test_show_network(dev, model, tmp_path, deterministic):
    """show_network at 448x1024 (flow) or 256x512 (interp), b1 bf16, with
    --trace-dir, a main path (a forward each for cost_analysis, time_fn's
    2 + 10 and the trace: K1 5 x 14): its TOTAL line, the trace naming
    K1's kernel 5 times, and its flops equal to the same forward's on the
    CPU (the kernels' plain versions, which the counter does not count)
    plus K1's formula."""
    from qpwcnet_torch.apps import show_network
    from qpwcnet_torch.models import build_flow_net, build_interpolator
    from qpwcnet_torch.utils.profiling import CATEGORIES, cost_analysis

    hw, levels, k1_batch, build_cpu = {
        "flow": ((H, W), CV_LEVELS, 1, build_flow_net),
        "interp": ((TRAIN_H, TRAIN_W), TRAIN_LEVELS, 2,
                   build_interpolator)}[model]
    cfg = show_network.Settings(model=model, height=hw[0], width=hw[1],
                                trace_dir=str(tmp_path),
                                compute_dtype="bfloat16", device=str(dev))
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        res, counts = launches(lambda: show_network.run(cfg))
    assert f"TOTAL: {res['params']:,} params" in said.getvalue().splitlines()
    main_path(counts, K1=5 * 14)
    traces = sorted(tmp_path.glob("*.pt.trace.json"))
    assert traces
    events = json.loads(traces[-1].read_text())["traceEvents"]
    k1 = dict(CATEGORIES)["K1"]
    assert sum(1 for e in events if e.get("cat") == "kernel"
               and re.search(k1, e.get("name", ""))) == 5
    cpu = cost_analysis(build_cpu(0, "cpu"),
                        torch.zeros((1, *hw, 6), dtype=F32))
    assert res["flops"] == cpu["flops"] + k1_flops(levels, k1_batch), (
        res["flops"], cpu["flops"])


@pytest.mark.cuda
def test_debug_nan_pretrain(dev, ibatch, tmp_path, deterministic):
    """pretrain_interp --debug-nan true against the run without it (2
    synthetic steps at 256x512 b8 bf16, a log each step), a main path (2
    steps and 2 held-out forwards): the logged metrics bit-equal; then the
    debug step on a batch with one NaN pixel raises FloatingPointError
    before the optimizer."""
    from qpwcnet_torch.apps import pretrain_interp
    from qpwcnet_torch.train import (
        create_interp_train_state, make_interp_train_step)

    logged = {}
    for flag in ("false", "true"):
        run_root = tmp_path / f"debug_nan_{flag}"
        _, counts = launches(lambda: pretrain_interp.main([
            "--steps", "2", "--batch-size", str(INTERP_B), "--height",
            str(TRAIN_H), "--width", str(TRAIN_W), "--compute-dtype",
            "bfloat16", "--recalibrate-final", "0", "--log-every", "1",
            "--ckpt-every", "100", "--device", str(dev), "--run-root",
            str(run_root), "--debug-nan", flag]))
        lines = (run_root / "000" / "log" / "metrics.jsonl").read_text()
        logged[flag] = [{k: v for k, v in json.loads(s).items()
                         if k not in ("images_per_sec", "time")}
                        for s in lines.splitlines()]
    assert len(logged["true"]) == 2 and logged["true"] == logged["false"]
    main_path(counts, K1=20, K4a=10, K4b=10)

    model = build_interp(BF16, dev, k=1.5)
    chain = create_interp_train_state(model, 1e-4)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    bad = {k: v.clone() for k, v in ibatch.items()}
    bad["ims"][-1, TRAIN_H // 3, TRAIN_W // 5, 4] = float("nan")
    with pytest.raises(FloatingPointError):
        make_interp_train_step(debug_nan=True)(model, chain, bad)
    assert chain.global_step == 0 and all(
        torch.equal(p, params[k]) for k, p in model.named_parameters())


@pytest.mark.cuda
def test_int8_spatial_forward(dev, x, deterministic):
    """The int8 forward at 448x1024 b8 exact in 2 local H shards (its
    convs exchanging int8 halo rows, K1's haloed mode), a main path,
    against the unsharded int8 forward: phase 4's bf16 model bound for the
    flow, at most 0.1% of the finest head's first chained conv's codes
    flipped."""
    from qpwcnet_torch.parallel import (
        SpatialConfig, make_mesh, make_spatial_forward, shard_batch_spatial,
        unshard_batch_spatial)

    calib = int8_calibrated(dev, x)
    n = SPATIAL_N_FWD
    mesh = make_mesh(n_data=1, n_model=n)
    codes = []
    with torch.inference_mode():
        ref = int8_flow(dev, "auto", calib)
        hook = emitted(ref, codes)
        want = ref(x)
        hook.remove()
        sp = int8_flow(dev, "auto", calib, spatial=SpatialConfig(
            mesh, warp_halo=SPATIAL_HALO_FWD))
        hook = emitted(sp, codes)
        fwd = make_spatial_forward(lambda m, ims: m(ims), mesh)
        out, counts = launches(lambda: fwd(sp, shard_batch_spatial(x, mesh)))
        hook.remove()
        got = unshard_batch_spatial(out, mesh)
    main_path(counts, **spatial_counts(H, n))
    assert counts["cost_volume_haloed_cuda"] > 0
    compare_model(got, want, BF16)
    d = (mesh.model.gather(codes[1], 2).int() - codes[0].int()).abs()
    assert int((d > 0).sum()) <= SHARDED_FLIP_SHARE * d.numel()


def graph_ops(exported) -> dict:
    """The calls of the kernels' custom ops in an ExportedProgram (its
    graph and any subgraph of it), by op name."""
    counts = {"qpwcnet.cost_volume": 0, "qpwcnet.warp_cost_volume": 0,
              "qpwcnet.bias_mish": 0}
    for gm in exported.graph_module.modules():
        graph = getattr(gm, "graph", None)
        for node in (graph.nodes if graph is not None else ()):
            for op in counts:
                if node.op == "call_function" and str(
                        node.target).startswith(op + "."):
                    counts[op] += 1
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_int8_export(dev, mode, tmp_path, deterministic):
    """convert_quant --export at 448x1024 b1 (exact: the app's own run, 3
    calibration steps, the bundle, the check and the export; 'fast':
    export_int8 of the int8 model): the graph holds the kernels' ops
    (exact: qpwcnet::cost_volume x5; 'fast': x4 and
    qpwcnet::warp_cost_volume x1; qpwcnet::bias_mish x44, the epilogue of
    each Mish conv), and the loaded .pt2 runs on the card (K1, K3 and the
    epilogue launched) bit-equal to the eager int8 forward holding the
    program's state."""
    from qpwcnet_torch.apps import convert_quant

    x1 = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.5, 0.5, (1, H, W, 6)).astype(np.float32)).to(dev)
    path = tmp_path / f"int8_{mode}.pt2"
    kernels.reset_launch_counts()
    if mode == "exact":
        convert_quant.run(dataclasses.replace(
            convert_quant.Settings(), steps=3, height=H, width=W,
            out=str(tmp_path / "int8.npz"), export=str(path),
            device=str(dev)))
    else:
        model = build(F32, dev, cv_impl="fast", quant=int8())
        model.load_state_dict(int8_calibrated(dev, x1).state_dict())
        convert_quant.export_int8(model, path, x1)
        del model
    exported = torch.export.load(str(path))
    assert graph_ops(exported) == {
        "qpwcnet.cost_volume": 5 if mode == "exact" else 4,
        "qpwcnet.warp_cost_volume": 0 if mode == "exact" else 1,
        "qpwcnet.bias_mish": 44}
    eager = build(F32, dev, k=0, quant=int8(),
                  cv_impl="auto" if mode == "exact" else "fast")
    missing, _ = eager.load_state_dict(exported.state_dict, strict=False)
    assert not missing, missing
    prog = exported.module()
    before = kernels.launch_counts()["bias_mish_cuda"]
    with torch.inference_mode():
        got = prog(x1)
        want = eager(x1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert counts["cost_volume_cuda"] > 0
    assert mode == "exact" or counts["warp_cost_volume_cuda"] > 0
    assert counts["bias_mish_cuda"] - before == 2 * 44, counts
    epilogue_ran(counts)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flow_mse_loss", "flow_finetune_loss",
                                  "backward_warp_manual", "invert_flow"])
def test_last_ops_card_matches_cpu(dev, x, name):
    """The last slice's losses, the manual warp and the flow inversion at
    448x1024 b8 float32: outputs and gradients on the card within 1e-5 of
    the CPU's magnitude."""
    from qpwcnet_torch.ops import backward_warp_manual, invert_flow
    from qpwcnet_torch.train import flow_finetune_loss, flow_mse_loss

    rng = np.random.RandomState(SEED + 40)
    flow = rng.uniform(-12, 12, (B, H, W, 2)).astype(np.float32)
    pred = rng.uniform(-3, 3, (B, H // 4, W // 4, 2)).astype(np.float32)
    img = x[..., :3].float().cpu().numpy()
    fn, arrays = {
        "flow_mse_loss": (flow_mse_loss, (flow, pred)),
        "flow_finetune_loss": (flow_finetune_loss, (flow, pred)),
        "backward_warp_manual": (backward_warp_manual, (img, flow)),
        "invert_flow": (invert_flow, (flow,))}[name]
    outs = []
    for d in ("cpu", dev):
        ts = [torch.from_numpy(a).to(d).requires_grad_() for a in arrays]
        y = fn(*ts)
        y.backward(torch.ones_like(y) if y.dim() else None)
        outs.append([y.detach().cpu()] + [t.grad.cpu() for t in ts])
    for got, want in zip(outs[1], outs[0]):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
def test_occlusion_and_decoding_card_match_cpu(dev):
    """At 448x1024 b8 float32: the occlusion mask on the card equals the
    CPU's but where a truncation met an integer boundary an ulp apart
    (0.1% of the pixels at most); cost_volume_to_flow's argmax decoding of
    a finest-level cost volume in half steps (many ties) exactly."""
    from qpwcnet_torch.ops import cost_volume_to_flow, estimate_occlusion_map

    rng = np.random.RandomState(SEED + 40)
    flow = rng.uniform(-12, 12, (B, H, W, 2)).astype(np.float32)
    rng.uniform(-3, 3, (B, H // 4, W // 4, 2))  # the losses' prediction
    cvol = (np.round(2.0 * rng.standard_normal((B, H // 2, W // 2, 81)))
            / 2.0).astype(np.float32)
    for fn, a, share in ((estimate_occlusion_map, flow, SHARDED_FLIP_SHARE),
                         (cost_volume_to_flow, cvol, 0)):
        want = fn(torch.from_numpy(a))
        got = fn(torch.from_numpy(a).to(dev)).cpu()
        assert int((got != want).sum()) <= share * want.numel(), fn


@pytest.mark.cuda
def test_schedules(dev):
    """The piecewise halving schedule halves at its boundary for the
    train step's batch (host functions: no card work)."""
    from qpwcnet_torch.train import piecewise_halving_schedule

    piecewise = piecewise_halving_schedule(TRAIN_B)
    b0 = int(400_000 * 8 / TRAIN_B)
    assert piecewise(b0) == 0.5 * piecewise(b0 - 1)
