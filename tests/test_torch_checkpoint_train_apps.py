"""Both train apps save and resume on CPU, and train_flow takes over a
pretraining checkpoint (split from tests/test_torch_checkpoint.py, whose
conventions hold: a resumed run must equal the uninterrupted one bit for
bit, and the step and label arithmetic after a curriculum is the JAX
app's).
"""

import json
import shutil

import torch

from qpwcnet_torch.apps import pretrain_interp, train_flow
from qpwcnet_torch.models import build_flow_net
from qpwcnet_torch.train import CheckpointManager

from tests.test_torch_checkpoint import (
    PRETRAIN_ARGS,
    TRAIN_ARGS,
    _assert_states_equal,
    _state,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401


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
