"""The PyTorch port's dataset modes of the apps on CPU, on tiny fixtures
in the datasets' own layouts (tests/test_torch_datasets.py writes them):
train_flow's host generator and first loader batches against the JAX
app's, pretrain_interp's against the JAX app's, a few steps of every mode
with finite metrics and a checkpoint, interp_infer on the datasets, and
the data_tools subcommands.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from qpwcnet_tpu.apps import pretrain_interp as j_pretrain
from qpwcnet_tpu.apps import train_flow as j_train
from qpwcnet_tpu.data import pipeline as j_pipeline
from qpwcnet_tpu.utils import cache as j_cache
from qpwcnet_torch.apps import (
    data_tools,
    interp_infer,
    pretrain_interp,
    train_flow,
)
from qpwcnet_torch.data import pipeline
from qpwcnet_torch.data.flo_format import write_flo
from qpwcnet_torch.utils.config import parse_config
from tests.test_torch_datasets import (
    _equal_batches,
    write_fc3d,
    write_vimeo,
    write_ytvos,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401

H, W = 32, 64


def write_sintel(root, n_frames=4, h=H, w=W, seed=3) -> None:
    """A Sintel tree: one sequence of n_frames PNGs and .flo files, a NaN
    in the first flow."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img = Path(root) / "training" / "final" / "seq"
    flo = Path(root) / "training" / "flow" / "seq"
    img.mkdir(parents=True)
    flo.mkdir(parents=True)
    for i in range(1, n_frames + 1):
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            img / f"frame_{i:04d}.png")
        f = rng.uniform(-4, 4, (h, w, 2)).astype(np.float32)
        if i == 1:
            f[5, 6, 1] = np.nan
        write_flo(flo / f"frame_{i:04d}.flo", f)


@pytest.fixture()
def fixtures(tmp_path, monkeypatch):
    """Every dataset at H x W (FlyingThings3D's and Sintel's fc3d set file
    and shards made by data_tools), the YouTube-VOS index caches in
    tmp_path, tmp_path the working directory (JAX globs shards relative
    to it)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QPWCNET_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(j_cache, "CACHE_DIR", tmp_path / "jax_cache")
    write_fc3d(tmp_path / "f3d", seqs=(("A", "0000", 4), ("B", "0001", 3)),
               h=H + 8, w=W + 16, nan_at=1)
    data_tools.main(["fc3d-set", "--root", str(tmp_path / "f3d"), "--out",
                     "set.txt"])
    write_sintel(tmp_path / "sintel")
    data_tools.main(["convert", "--root", str(tmp_path / "sintel"), "--out",
                     "shards", "--shards", "2"])
    write_vimeo(tmp_path / "vimeo", train=tuple(f"0000{i}/0001"
                                                for i in range(4)),
                test=("00009/0001", "00009/0002"), h=H, w=W + 8)
    write_ytvos(tmp_path / "ytvos", frames=(6, 4, 3, 5), h=H + 4, w=W)
    write_ytvos(tmp_path / "ytvos", split="valid", frames=(3, 4), h=H, w=W)
    return tmp_path


# relative to the fixtures' directory (the working directory); JAX's
# sintel mode globs relative paths only
DATA_PATH = {"fc3d": "set.txt", "sintel": "shards/*.tfrecord",
             "vimeo": "vimeo", "ytvos": "ytvos", "dummy": "",
             "synthetic-uniform": ""}


def _abs(data: str) -> str:
    """DATA_PATH[data] as an absolute path (a loader's thread may still
    read a file after the test has left the directory)."""
    p = DATA_PATH[data]
    return str(Path.cwd() / p) if p and data != "sintel" else p


def _cfgs(port_mod, jax_mod, data, **kw):
    fields = dict(data=data, data_path=_abs(data), batch_size=2,
                  height=H, width=W, **kw)
    return port_mod.Settings(**fields), jax_mod.Settings(**fields)


# ------------------------------------------------------------ train_flow

def test_synthetic_batches_match_jax():
    cfg, jcfg = _cfgs(train_flow, j_train, "synthetic-uniform", seed=3)
    got = train_flow._synthetic_batches(cfg, start_step=5)
    want = j_train._synthetic_batches(jcfg, start_step=5)
    for _ in range(3):
        assert _equal_batches(next(got), next(want))


@pytest.mark.parametrize("data", ["fc3d", "sintel"])
def test_train_flow_loader_matches_jax(fixtures, data):
    """The first batches of the app's loader, bit-equal to the JAX app's
    (its default four workers: the flow decoders draw nothing)."""
    cfg, jcfg = _cfgs(train_flow, j_train, data)
    loader = train_flow._dataset_loader(cfg)
    got, want = iter(loader), j_train._dataset_batches(jcfg)
    for _ in range(4):
        g, w = next(got), next(want)
        assert _equal_batches(g, w) and g[0].shape == (2,) + g[0].shape[1:]
    loader.close()


def _run_train_flow(root, data, *extra, steps=2):
    args = ["--data", data, "--data-path", _abs(data), "--steps",
            str(steps), "--batch-size", "2", "--height", str(H), "--width",
            str(W), "--device", "cpu", "--log-every", "1",
            "--recalibrate-final", "1", "--ckpt-every", "100",
            "--run-root", str(root / "runs")]
    return train_flow.main(args + list(extra))


@pytest.mark.parametrize("data, extra", [
    ("fc3d", ["--base-scale", "0.56"]), ("sintel", []),
    ("synthetic-uniform", []), ("synthetic-uniform", ["--augment", "on"])])
def test_train_flow_host_data_runs_on_cpu(fixtures, capsys, data, extra):
    metrics = _run_train_flow(fixtures, data, *extra)
    assert set(metrics) == {"loss", "epe"}
    assert all(np.isfinite(v) for v in metrics.values())
    err = capsys.readouterr().err
    assert "step 2: loss=" in err and "loader wait" in err
    assert "recalibrated BN stats" in err
    run = fixtures / "runs" / "000"
    assert (run / "ckpt" / "2" / "state.pt").exists()
    rows = [json.loads(r) for r in
            (run / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loader_wait_ms"]) and np.isfinite(
        r["epe_eval"]) for r in rows)


def test_train_flow_synthetic_augment_on(tmp_path):
    """--augment on with the on-device generator (refused before the
    flow augmentation was ported)."""
    metrics = train_flow.main([
        "--augment", "on", "--curriculum", "", "--steps", "2",
        "--batch-size", "2", "--height", str(H), "--width", str(W),
        "--device", "cpu", "--log-every", "1", "--recalibrate-final", "0",
        "--run-root", str(tmp_path)])
    assert all(np.isfinite(v) for v in metrics.values())


def test_train_flow_resumes_the_host_generator(fixtures):
    """synthetic-uniform resumed at step 1 replays the uninterrupted run:
    its batches are indexed by the step (the datasets' loaders restart at
    their first epoch, as JAX's do)."""
    extra = ["--ckpt-every", "1", "--recalibrate-final", "0"]

    def state(run):
        return torch.load(fixtures / "runs" / run / "ckpt" / "2" /
                          "state.pt", weights_only=True)["model"]

    _run_train_flow(fixtures, "synthetic-uniform", *extra)
    _run_train_flow(fixtures, "synthetic-uniform", *extra, steps=1)
    _run_train_flow(fixtures, "synthetic-uniform", *extra, "--load-ckpt",
                    str(fixtures / "runs" / "001" / "ckpt"))
    a, c = state("000"), state("002")
    assert all(torch.equal(a[k], c[k]) for k in a)


# ------------------------------------------------------- pretrain_interp

@pytest.mark.parametrize("data", ["vimeo", "ytvos", "dummy"])
def test_pretrain_loader_matches_jax(fixtures, data):
    """The app's dataset through the loader, bit-equal to the JAX app's
    with one worker (YouTube-VOS draws its gaps from a RandomState that
    the workers share)."""
    cfg, jcfg = _cfgs(pretrain_interp, j_pretrain, data)
    ds, jds = pretrain_interp._make_dataset(cfg), j_pretrain._make_dataset(
        jcfg)
    assert len(ds) == len(jds) and ds.keys() == jds.keys()
    got = pipeline.PrefetchLoader(pipeline.triplet_sample_fn(ds, (H, W)),
                                  len(ds), 2, n_workers=1)
    want = j_pipeline.PrefetchLoader(
        j_pipeline.triplet_sample_fn(jds, (H, W)), len(jds), 2, n_workers=1)
    for g, w in zip(iter(got), iter(want)):
        assert _equal_batches(g, w) and g[0].shape == (2, H, W, 3)
        break
    got.close()
    want.close()
    loader = pretrain_interp._triplet_loader(cfg)
    assert loader.n_samples == len(ds) and loader.batch_size == 2
    loader.close()


@pytest.mark.parametrize("data", ["vimeo", "ytvos", "dummy"])
def test_pretrain_datasets_run_on_cpu(fixtures, capsys, data):
    metrics = pretrain_interp.main([
        "--data", data, "--data-path", _abs(data), "--steps", "2",
        "--batch-size", "2", "--height", str(H), "--width", str(W),
        "--device", "cpu", "--log-every", "1", "--recalibrate-final", "1",
        "--run-root", str(fixtures / "pre")])
    assert {"loss", "loader_wait_ms"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    err = capsys.readouterr().err
    assert "step 2: loss=" in err and "recalibrated BN stats" in err
    assert (fixtures / "pre" / "000" / "ckpt" / "2" / "state.pt").exists()


# ---------------------------------------------------------- interp_infer

@pytest.mark.parametrize("data", ["vimeo", "ytvos"])
def test_interp_infer_datasets_run_on_cpu(fixtures, data):
    """The first --n triplets of Vimeo's 'test' / YouTube-VOS's 'valid'
    split, frames resized as the JAX app resizes them."""
    out = fixtures / f"out_{data}"
    results = interp_infer.main(["--data", data, "--data-path",
                                 _abs(data), "--n", "2", "--height",
                                 str(H), "--width", str(W), "--device",
                                 "cpu", "--out-dir", str(out)])
    assert len(results) == 2
    assert all(np.isfinite(r["psnr"]) and np.isfinite(r["halfwarp_l1"])
               for r in results)
    assert len(list(out.glob("*.png"))) == 14
    cfg = parse_config(interp_infer.Settings, ["--data", data, "--data-path",
                                               _abs(data), "--n", "1"])
    frames = next(interp_infer._triplets(cfg))
    assert all(f.shape == (256, 512, 3) and f.dtype == np.float32
               for f in frames)


def test_interp_infer_refuses_an_unknown_source(tmp_path):
    with pytest.raises(ValueError, match="unknown data source"):
        interp_infer.main(["--data", "kitti", "--device", "cpu",
                           "--out-dir", str(tmp_path)])


# ------------------------------------------------------------ data_tools

def test_data_tools(fixtures, capsys):
    """stats and nan-scan print what the JAX tools print; preview writes
    its grid (augmentation on the CPU here)."""
    from qpwcnet_tpu.apps import data_tools as j_tools

    for argv in (["stats", "--shards", DATA_PATH["sintel"]],
                 ["nan-scan", "--set-file", "set.txt"]):
        data_tools.main(argv)
        got = capsys.readouterr().out
        j_tools.main(argv)
        assert got == capsys.readouterr().out
    data_tools.main(["nan-scan", "--set-file", "set.txt"])
    assert capsys.readouterr().out.strip() == "1/5 samples contain NaNs"
    data_tools.main(["preview", "--shards", DATA_PATH["sintel"], "--out",
                     "p.png", "--height", "16", "--width", "32",
                     "--device", "cpu"])
    from PIL import Image

    with Image.open(fixtures / "p.png") as im:
        assert im.size == (3 * W, 2 * H)
    assert len(list((fixtures / "shards").glob("*.tfrecord"))) == 2
