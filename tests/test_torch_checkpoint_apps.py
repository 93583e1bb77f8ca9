"""The inference apps load a checkpoint, --load-ckpt without one starts
fresh, and eval_sintel against the JAX package's, on CPU (split from
tests/test_torch_checkpoint.py).
"""

import json

import jax
import numpy as np
import pytest
import torch

from qpwcnet_torch.apps import (
    eval_sintel,
    infer,
    interp_infer,
    pretrain_interp,
    train_flow,
)
from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.train import CheckpointManager, plain_optimizer
from qpwcnet_torch.utils.config import parse_config
from qpwcnet_tpu.train.checkpoint import CheckpointManager as JCheckpoints

from tests.test_torch_checkpoint import PRETRAIN_ARGS, TRAIN_ARGS, _state
from tests.test_torch_model import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("app", ["infer", "interp_infer"])
def test_inference_apps_load_a_checkpoint(tmp_path, app):
    """infer / interp_infer --load-ckpt: the JAX app's model ('diag'
    heads, no residual) with the checkpoint's parameters and statistics,
    from a train_flow (unit heads, residual: the same shapes, another
    function, as in JAX) or pretrain_interp run."""
    if app == "infer":
        train_flow.main(TRAIN_ARGS + ["--steps", "2", "--run-root",
                                      str(tmp_path / "runs")])
        mod = infer
    else:
        pretrain_interp.main(PRETRAIN_ARGS + ["--steps", "2", "--run-root",
                                              str(tmp_path / "runs")])
        mod = interp_infer
    ckpt = tmp_path / "runs" / "000" / "ckpt"
    argv = ["--device", "cpu", "--height", "32", "--width", "64", "--n",
            "1", "--out-dir", str(tmp_path / "out"), "--load-ckpt",
            str(ckpt)]
    if app == "interp_infer":
        argv += ["--data", "synthetic"]
    model = mod.build_model(parse_config(mod.Settings, argv))
    mods = list(model.modules())
    assert {m.head_scale for m in mods if hasattr(m, "head_scale")} == \
        {"diag"}
    assert {m.residual for m in mods if hasattr(m, "residual")} == {False}
    want = _state(ckpt, 2)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    results = mod.main(argv)
    assert len(results) == 1
    assert len(list((tmp_path / "out").glob("*.png"))) == (
        5 if app == "infer" else 7)


@pytest.mark.parametrize("app", ["train_flow", "pretrain_interp", "infer",
                                 "interp_infer"])
def test_load_ckpt_without_a_checkpoint_starts_fresh(tmp_path, app):
    """--load-ckpt at a directory that holds no checkpoint: JAX's
    restore returns its template (train/checkpoint.py:55-60), so the
    train apps start at step 0 and the inference apps keep the seed-0
    weights."""
    empty = tmp_path / "empty"
    empty.mkdir()
    if app in ("train_flow", "pretrain_interp"):
        mod = train_flow if app == "train_flow" else pretrain_interp
        args = TRAIN_ARGS if app == "train_flow" else PRETRAIN_ARGS
        mod.main(args + ["--steps", "2", "--load-ckpt", str(empty),
                         "--run-root", str(tmp_path / "runs")])
        ckpt = tmp_path / "runs" / "000" / "ckpt"
        assert CheckpointManager(ckpt).all_steps() == [2]
        assert _state(ckpt, 2)["step"] == 2
    else:
        mod = infer if app == "infer" else interp_infer
        cfg = parse_config(mod.Settings, ["--device", "cpu",
                                          "--load-ckpt", str(empty)])
        seeded = mod.build_model(parse_config(mod.Settings,
                                              ["--device", "cpu"]))
        for (k, a), (_, b) in zip(mod.build_model(cfg).state_dict().items(),
                                  seeded.state_dict().items()):
            assert torch.equal(a, b), k
    assert not any(empty.iterdir())


# ------------------------------------------------------------ eval_sintel

def _sintel_fixture(root, rng, h=40, w=72):
    """A Sintel-layout tree of one sequence with 2 frames and 1 flow."""
    from qpwcnet_torch.data.flo_format import write_flo
    from qpwcnet_torch.vis import write_png

    img = root / "training" / "final" / "seq"
    flo = root / "training" / "flow" / "seq"
    img.mkdir(parents=True)
    flo.mkdir(parents=True)
    for i in (1, 2):
        write_png(img / f"frame_{i:04d}.png",
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    write_flo(flo / "frame_0001.flo",
              rng.uniform(-3, 3, (h, w, 2)).astype(np.float32))


@pytest.mark.parametrize("protocol", ["pad", "resize"])
def test_eval_sintel_matches_jax(tmp_path, capsys, protocol):
    """The same seeded variables saved by JAX's CheckpointManager (a
    create_flow_train_state state) and by the port's after
    load_flax_variables; both apps with --load-ckpt --recalibrate 1 on a
    40x72 fixture ('pad' runs at 64x96; 'resize' at 64x96 too): the EPEs
    agree to a relative 1e-4 (float32)."""
    from qpwcnet_tpu.apps import eval_sintel as j_eval_sintel
    from qpwcnet_tpu.models import build_flow_net as j_build_flow_net
    from qpwcnet_tpu.train import create_flow_train_state
    from tests.test_torch_model import _seeded

    _sintel_fixture(tmp_path / "sintel", np.random.RandomState(5))
    model_j, variables = j_build_flow_net(jax.random.key(0))
    v = _seeded(variables, "diag", seed=3, hw=(64, 96))
    jm = JCheckpoints(tmp_path / "jax")
    jm.save(0, create_flow_train_state(model_j, v))
    jm.wait()
    jm.close()
    model = load_flax_variables(build_flow_net(0, "cpu"), v)
    CheckpointManager(tmp_path / "port").save(0, model,
                                              plain_optimizer(model, 1e-4))
    args = ["--data-path", str(tmp_path / "sintel"), "--protocol", protocol,
            "--height", "64", "--width", "96", "--recalibrate", "1"]
    capsys.readouterr()
    j_eval_sintel.main(args + ["--load-ckpt", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_sintel.main(args + ["--load-ckpt", str(tmp_path / "port"),
                                   "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got
    assert got["n"] == want["n"] == 1 and got["protocol"] == protocol
    assert got["metric"] == want["metric"] == "sintel EPE"
    assert abs(got["value"] - want["value"]) <= 1e-4 * abs(want["value"])
    # not vacuous: the predicted flows move the EPE off predict-zero's
    from qpwcnet_torch.data.flo_format import read_flo

    gt = read_flo(tmp_path / "sintel" / "training" / "flow" / "seq"
                  / "frame_0001.flo")
    zero = float(np.mean(np.linalg.norm(gt, axis=-1)))
    assert abs(got["value"] - zero) > 0.05 * zero, (got["value"], zero)
