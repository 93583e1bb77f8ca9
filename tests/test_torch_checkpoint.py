"""The port's checkpoints, run directories and metrics on CPU: the
checkpoint manager against Orbax's save rules, the round trip, and the
run directory and metric writer. The apps that need them are in
tests/test_torch_checkpoint_train_apps.py (both train apps save and
resume, the weight handover from a pretraining checkpoint) and
tests/test_torch_checkpoint_apps.py (the inference apps load a
checkpoint, eval_sintel against the JAX package's): three files, so that
the test workers run them side by side.

Where JAX has the same rule (Orbax's save at an existing step, restore
without a checkpoint, the train app's step and label arithmetic after a
curriculum), the test holds the port to it; a resumed run must equal the
uninterrupted one bit for bit (the same process, the same CPU kernels).
"""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from qpwcnet_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from qpwcnet_tpu.train.train_state import TrainState
from qpwcnet_torch.apps import train_flow
from qpwcnet_torch.models import build_flow_net
from qpwcnet_torch.train import (
    CheckpointManager,
    MetricWriter,
    default_optimizer,
    make_flow_train_step,
    plain_optimizer,
)
from qpwcnet_torch.utils.config import parse_config
from qpwcnet_torch.utils.runs import setup_run_dir, snapshot_config
from tests.test_torch_model import one_torch_thread  # noqa: F401

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
