"""The port's checkpoints, run directories and metrics on CPU, and the apps
that need them: both train apps save and resume, the weight handover
from a pretraining checkpoint, the inference apps load a checkpoint, and
eval_sintel against the JAX package's.

Where JAX has the same rule (Orbax's save at an existing step, restore
without a checkpoint, the train app's step and label arithmetic after a
curriculum), the test holds the port to it; a resumed run must equal the
uninterrupted one bit for bit (the same process, the same CPU kernels).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from qpwcnet_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from qpwcnet_tpu.train.train_state import TrainState
from qpwcnet_torch.apps import (
    eval_sintel,
    infer,
    interp_infer,
    pretrain_interp,
    train_flow,
)
from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.train import (
    CheckpointManager,
    MetricWriter,
    default_optimizer,
    make_flow_train_step,
    plain_optimizer,
)
from qpwcnet_torch.utils.config import parse_config
from qpwcnet_torch.utils.runs import setup_run_dir, snapshot_config

TRAIN_ARGS = ["--device", "cpu", "--curriculum", "", "--batch-size", "2",
              "--height", "32", "--width", "64", "--log-every", "1",
              "--recalibrate-final", "2", "--ckpt-every", "2"]
PRETRAIN_ARGS = ["--device", "cpu", "--batch-size", "2", "--height", "32",
                 "--width", "64", "--log-every", "1", "--recalibrate-final",
                 "2", "--ckpt-every", "2"]


def _state(ckpt_dir, step):
    return torch.load(ckpt_dir / str(step) / "state.pt", weights_only=True)


def _assert_states_equal(a, b):
    """Two checkpoints' step, model state_dict and Adam state, bit for
    bit."""
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][name], sb[i][name]), (i, name)


def _trained_flow_net(steps=2, chain=plain_optimizer):
    """A flow net and its chain after ``steps`` train steps at 32x64 b2."""
    model = build_flow_net(0, "cpu", head_scale="unit", residual=True)
    opt = chain(model, 1e-3)
    rng = np.random.RandomState(0)
    step = make_flow_train_step()
    for _ in range(steps):
        step(model, opt, {
            "ims": torch.from_numpy(rng.uniform(
                -0.5, 0.5, (2, 32, 64, 6)).astype(np.float32)),
            "flo": torch.from_numpy(rng.uniform(
                -2, 2, (2, 32, 64, 2)).astype(np.float32))})
    return model, opt


# --------------------------------------------------------------- manager

def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    """Save after two steps; restore into a model built from another
    seed and a fresh chain: parameters, BatchNorm statistics, Adam
    state, the step and one forward are bit-equal."""
    model, opt = _trained_flow_net()
    mgr = CheckpointManager(tmp_path)
    assert mgr.save(2, model, opt)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2"]
    other = build_flow_net(1, "cpu", head_scale="unit", residual=True)
    chain = plain_optimizer(other, 1e-3)
    assert CheckpointManager(tmp_path).restore(other, chain) == 2
    assert chain.global_step == opt.global_step == 2
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    for p, q in zip(model.parameters(), other.parameters()):
        a, b = opt.adam.state[p], chain.adam.state[q]
        assert a.keys() == b.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for name in a:
            assert torch.equal(a[name], b[name]), name
        assert b["step"].device.type == "cpu"
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.5, 0.5, (1, 32, 64, 6)).astype(np.float32))
    model.eval()
    other.eval()
    with torch.no_grad():
        assert torch.equal(model(x), other(x))


def test_restore_without_checkpoint_touches_nothing(tmp_path):
    model, opt = _trained_flow_net(steps=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mgr = CheckpointManager(tmp_path / "none")
    assert mgr.latest_step() is None
    assert mgr.restore(model, opt) is None
    assert mgr.restore_params(model) is None
    assert opt.global_step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # JAX returns its template unchanged
    state = _jax_state(0, 1.0)
    assert JCheckpoints(tmp_path / "none_jax").restore(state) is state


def test_restore_params_ignores_the_optimizer(tmp_path):
    """restore_params loads the parameters, the statistics and the step
    from a checkpoint saved with the reference chain, and leaves the
    caller's chain (here a plain one) as it was."""
    model, opt = _trained_flow_net(chain=default_optimizer)
    CheckpointManager(tmp_path).save(7, model, opt)
    other = build_flow_net(1, "cpu", head_scale="unit", residual=True)
    chain = plain_optimizer(other, 1e-3)
    assert CheckpointManager(tmp_path).restore_params(other) == 2
    assert chain.adam.state == {} and chain.global_step == 0
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k


def test_max_to_keep_and_latest_step(tmp_path):
    model = nn.Sequential(nn.Conv2d(2, 3, 1), nn.BatchNorm2d(3))
    opt = plain_optimizer(model, 1e-3)
    mgr = CheckpointManager(tmp_path, max_to_keep=3)
    for step in (1, 2, 5, 9, 10):
        assert mgr.save(step, model, opt)
        assert mgr.latest_step() == step
    assert mgr.all_steps() == [5, 9, 10]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["10", "5", "9"]


def test_interrupted_save_keeps_the_previous_checkpoint(tmp_path,
                                                        monkeypatch):
    """A save that dies while writing leaves the latest checkpoint as it
    was and no partial step behind."""
    model = nn.Sequential(nn.Conv2d(2, 3, 1), nn.BatchNorm2d(3))
    opt = plain_optimizer(model, 1e-3)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, model, opt)

    def dies(obj, path):
        path.write_bytes(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, model, opt)
    monkeypatch.undo()
    assert mgr.all_steps() == [1]
    assert [p.name for p in tmp_path.iterdir()] == ["1"]
    assert mgr.restore(model, opt) == 0


def _jax_state(step, value):
    params = {"w": jnp.full((3,), value)}
    tx = optax.adam(1e-3)
    return TrainState(step=jnp.asarray(step, jnp.int32), params=params,
                      batch_stats={"m": jnp.full((3,), -value)},
                      opt_state=tx.init(params), apply_fn=None, tx=tx)


def test_save_rules_match_orbax(tmp_path):
    """The JAX CheckpointManager (Orbax) beside the port's on one
    sequence of saves: a save at an existing step, or below the latest,
    is a no-op that keeps the first checkpoint; max_to_keep drops the
    oldest steps."""
    jm = JCheckpoints(tmp_path / "jax", max_to_keep=3)
    pm = CheckpointManager(tmp_path / "port", max_to_keep=3)
    model = nn.Linear(3, 1, bias=False)
    opt = plain_optimizer(model, 1e-3)
    for step, value in ((2, 1.0), (2, 2.0), (1, 3.0), (4, 4.0), (6, 5.0),
                        (8, 6.0), (8, 7.0)):
        before = list(jm._mgr.all_steps())
        jm.save(step, _jax_state(step, value))
        jm.wait()
        with torch.no_grad():
            model.weight.fill_(value)
        opt.global_step = step
        saved = pm.save(step, model, opt)
        assert saved == (list(jm._mgr.all_steps()) != before), step
        assert sorted(jm._mgr.all_steps()) == pm.all_steps(), step
        assert jm.latest_step() == pm.latest_step()
    assert pm.all_steps() == [4, 6, 8]
    for step, value in ((4, 4.0), (8, 6.0)):
        got = jm.restore(_jax_state(0, 0.0), step=step)
        assert float(got.params["w"][0]) == value
        assert pm.restore(model, opt, step=step) == step
        assert float(model.weight.detach()[0, 0]) == value
    jm.close()


# ----------------------------------------------------- runs and metrics

def test_setup_run_dir_and_config(tmp_path, monkeypatch):
    first = setup_run_dir(tmp_path / "runs")
    assert first["run"] == tmp_path / "runs" / "000"
    assert first["log"].is_dir() and first["ckpt"].is_dir()
    (tmp_path / "runs" / "007").mkdir()
    (tmp_path / "runs" / "notes").mkdir()
    assert setup_run_dir(tmp_path / "runs")["run"].name == "008"
    cfg = train_flow.Settings(steps=7, curriculum="", device="cpu")
    snapshot_config(first["run"], cfg)
    saved = json.loads((first["run"] / "config.json").read_text())
    assert saved["steps"] == 7 and saved["curriculum"] == ""
    assert parse_config(train_flow.Settings, [
        "--config", str(first["run"] / "config.json")]) == cfg
    # the default root lies under the temporary directory
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path / "tmp"))
    assert setup_run_dir()["run"] == \
        tmp_path / "tmp" / "qpwcnet_torch" / "run" / "000"


def test_metric_writer_jsonl(tmp_path):
    writer = MetricWriter(tmp_path / "log")
    writer.scalars(3, {"loss": torch.tensor(0.5), "epe": 2})
    writer.scalars(5, {"loss": 0.25})
    writer.flow_image(5, "flow", torch.ones(2, 8, 12, 2))
    writer.image(5, "img", np.full((8, 12, 3), 2.0, np.float32))
    writer.close()
    recs = [json.loads(line) for line in
            (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [3, 5]
    assert recs[0]["loss"] == 0.5 and recs[0]["epe"] == 2.0
    assert set(recs[1]) == {"step", "time", "loss"}
    assert recs[0]["time"] <= recs[1]["time"]


# ------------------------------------------------------------ train apps

def test_train_flow_resume_replays_the_uninterrupted_run(tmp_path):
    """4 steps, against 2 steps and a resume to 4 (--curriculum ''): the
    final checkpoints are bit-equal. Each run's final save at the
    periodic step is a no-op, as Orbax's, so both hold the periodic,
    unrecalibrated state; the metrics log holds every step."""
    runs = tmp_path / "runs"
    args = TRAIN_ARGS + ["--run-root", str(runs)]
    train_flow.main(args + ["--steps", "4"])
    train_flow.main(args + ["--steps", "2"])
    train_flow.main(args + ["--steps", "4", "--load-ckpt",
                            str(runs / "001" / "ckpt")])
    assert CheckpointManager(runs / "000" / "ckpt").all_steps() == [2, 4]
    assert CheckpointManager(runs / "001" / "ckpt").all_steps() == [2]
    assert CheckpointManager(runs / "002" / "ckpt").all_steps() == [4]
    _assert_states_equal(_state(runs / "000" / "ckpt", 4),
                         _state(runs / "002" / "ckpt", 4))
    recs = [json.loads(line) for line in (runs / "002" / "log"
                                          / "metrics.jsonl").open()]
    assert [r["step"] for r in recs] == [3, 4]
    assert {"loss", "epe", "epe_eval", "epe_zero",
            "images_per_sec"} <= set(recs[0])
    assert json.loads((runs / "002" / "config.json").read_text())[
        "load_ckpt"] == str(runs / "001" / "ckpt")


def test_train_flow_curriculum_step_and_labels(tmp_path, capsys):
    """The JAX app reads its step before the curriculum
    (qpwcnet_tpu/apps/train_flow.py:462), the curriculum's steps
    increment the stored step (train/train_state.py:50), periodic saves
    are labelled by the main loop's index from that step (:386-388) and
    the final save by the stored step (:405). So with 3 curriculum steps
    and --steps 2 --ckpt-every 2: labels 2 and 5, both storing step 5
    (label 5 after the recalibration). A resume from label 2 starts at
    the stored step 5, not at 2 (:459-467): with --steps 8 it runs steps
    5, 6, 7 on batches 5, 6, 7, saves labels 6 and 8, and its final
    save at 8 is a no-op."""
    runs = tmp_path / "runs"
    args = ["--device", "cpu", "--curriculum", "0,3", "--batch-size", "2",
            "--height", "64", "--width", "128", "--log-every", "1",
            "--recalibrate-final", "1", "--ckpt-every", "2", "--run-root",
            str(runs)]
    train_flow.main(args + ["--steps", "2"])
    err = capsys.readouterr().err
    assert "skip 1/4 stage" in err and "[curriculum 1/2] step 3:" in err
    ckpt = runs / "000" / "ckpt"
    assert CheckpointManager(ckpt).all_steps() == [2, 5]
    assert _state(ckpt, 2)["step"] == _state(ckpt, 5)["step"] == 5
    only2 = tmp_path / "only2"
    only2.mkdir()
    shutil.copytree(ckpt / "2", only2 / "2")
    train_flow.main(args + ["--steps", "8", "--load-ckpt", str(only2)])
    err = capsys.readouterr().err
    assert "[curriculum" not in err
    resumed = runs / "001"
    assert CheckpointManager(resumed / "ckpt").all_steps() == [6, 8]
    assert _state(resumed / "ckpt", 6)["step"] == 6
    assert _state(resumed / "ckpt", 8)["step"] == 8
    recs = [json.loads(line) for line in
            (resumed / "log" / "metrics.jsonl").open()]
    assert [r["step"] for r in recs] == [6, 7, 8]


def test_train_flow_saves_on_interrupt(tmp_path, monkeypatch):
    """KeyboardInterrupt in the third step: the two steps taken are
    saved, after the recalibration."""
    import qpwcnet_torch.train as train

    make = train.make_flow_train_step

    def interrupted(*a, **kw):
        step = make(*a, **kw)
        calls = []

        def wrapped(*args):
            calls.append(1)
            if len(calls) == 3:
                raise KeyboardInterrupt
            return step(*args)
        return wrapped

    monkeypatch.setattr(train, "make_flow_train_step", interrupted)
    train_flow.main(TRAIN_ARGS + ["--steps", "5", "--ckpt-every", "100",
                                  "--run-root", str(tmp_path)])
    ckpt = tmp_path / "000" / "ckpt"
    assert CheckpointManager(ckpt).all_steps() == [2]
    assert _state(ckpt, 2)["step"] == 2


def test_pretrain_resume_replays_the_uninterrupted_run(tmp_path):
    """The same for pretrain_interp, augmentation on: batches and
    augmentation draws are indexed by the global step."""
    runs = tmp_path / "runs"
    args = PRETRAIN_ARGS + ["--run-root", str(runs)]
    pretrain_interp.main(args + ["--steps", "4"])
    pretrain_interp.main(args + ["--steps", "2"])
    pretrain_interp.main(args + ["--steps", "4", "--load-ckpt",
                                 str(runs / "001" / "ckpt")])
    assert CheckpointManager(runs / "001" / "ckpt").all_steps() == [2]
    _assert_states_equal(_state(runs / "000" / "ckpt", 4),
                         _state(runs / "002" / "ckpt", 4))
    recs = [json.loads(line) for line in (runs / "002" / "log"
                                          / "metrics.jsonl").open()]
    assert [r["step"] for r in recs] == [3, 4]
    assert {"loss", "mse_eval", "img_5_loss",
            "images_per_sec"} <= set(recs[0])


def test_transfer_from_interp(tmp_path, capsys):
    """train_flow --load-ckpt <a pretrain_interp ckpt dir>
    --transfer-from-interp true: the encoder, decoder and flower are the
    interpolator's, the BatchNorm statistics the fresh flow model's, the
    step 0 and no curriculum runs. (--steps 0: the final checkpoint is
    the state before the first step.)"""
    pretrain_interp.main(PRETRAIN_ARGS + ["--steps", "2", "--run-root",
                                          str(tmp_path / "pre")])
    src = _state(tmp_path / "pre" / "000" / "ckpt", 2)["model"]
    capsys.readouterr()
    train_flow.main(["--device", "cpu", "--curriculum", "5", "--steps", "0",
                     "--height", "64", "--width", "128",
                     "--recalibrate-final", "0", "--load-ckpt",
                     str(tmp_path / "pre" / "000" / "ckpt"),
                     "--transfer-from-interp", "true", "--run-root",
                     str(tmp_path / "flow")])
    assert "[curriculum" not in capsys.readouterr().err
    got = _state(tmp_path / "flow" / "000" / "ckpt", 0)
    fresh = build_flow_net(0, "cpu", head_scale="unit", residual=True)
    params = {k for k, _ in fresh.named_parameters()}
    assert got["step"] == 0
    for k, v in got["model"].items():
        if k in params:
            assert k.split(".")[0] in ("encoder", "decoder", "flower")
            assert torch.equal(v, src[k]), k
        else:
            assert torch.equal(v, fresh.state_dict()[k]), k


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
