"""The port's own spans and counters (qpwcnet_torch/utils/tracing.py) on
the CPU: nothing recorded while tracing is off, the train steps' and
the models' span trees while it is on, spans closed by an exception,
the spans as ``qpwcnet.<name>`` ranges of a torch.profiler trace on its
clock, and the kernels' launch counts kept as counters."""

import sys
import threading

import numpy as np
import pytest
import torch

from qpwcnet_torch.models import build_flow_net, build_interpolator
from qpwcnet_torch.ops import cuda as kernels
from qpwcnet_torch.train import (
    create_interp_train_state,
    default_optimizer,
    make_flow_train_step,
    make_interp_train_step,
)
from qpwcnet_torch.utils import tracing
from tests.conftest import TEST_HW
from tests.test_torch_model import one_torch_thread  # noqa: F401

H, W = TEST_HW

FORWARD = {"encoder": None, "decoder": None, "flower": None,
           **{f"flower.l{i}": "flower" for i in range(5)},
           "flower.out": "flower"}
OPTIMIZER = {"opt.allreduce": "step.optimizer",
             "opt.nan_scrub": "step.optimizer",
             "opt.agc": "step.optimizer", "opt.adam": "step.optimizer"}


def _tree(forward: str, epe: bool) -> dict:
    """{span: its parent's name} of one train step."""
    tree = {"train_step": None, "step.zero_grad": "train_step",
            "step.forward": "train_step", forward: "step.forward",
            "step.loss": "train_step", "step.backward": "train_step",
            "step.optimizer": "train_step", **OPTIMIZER}
    tree.update({k: v or forward for k, v in FORWARD.items()})
    if epe:
        tree["step.epe"] = "train_step"
    return tree


@pytest.fixture(autouse=True)
def fresh_tracing():
    """Tracing off and the store empty before each test, as they were
    after."""
    was = tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(was)
    tracing.clear()


def _flow_step():
    rng = np.random.RandomState(0)
    model = build_flow_net(0, "cpu")
    opt = default_optimizer(model, 1e-4)
    batch = {"ims": torch.from_numpy(rng.uniform(
        -0.5, 0.5, (2, H, W, 6)).astype(np.float32)),
        "flo": torch.from_numpy(rng.uniform(
            -2, 2, (2, H, W, 2)).astype(np.float32))}
    return lambda: make_flow_train_step()(model, opt, batch)


def _interp_step():
    rng = np.random.RandomState(1)
    model = build_interpolator(0, "cpu")
    opt = create_interp_train_state(model, 1e-4)
    batch = {"ims": torch.from_numpy(rng.uniform(
        -0.5, 0.5, (2, H, W, 6)).astype(np.float32)),
        "mid": torch.from_numpy(rng.uniform(
            -0.5, 0.5, (2, H, W, 3)).astype(np.float32))}
    return lambda: make_interp_train_step()(model, opt, batch)


def test_off_records_nothing():
    """Off (the default), a flow train step records no span, and a span
    is one shared no-op context."""
    assert not tracing.enabled()
    _flow_step()()
    assert tracing.spans() == []
    assert tracing.span("a") is tracing.span("b")


@pytest.mark.parametrize("kind", ["flow", "interp"])
def test_train_step_tree(kind):
    """On, one step records the documented tree once each, every child
    on the caller's thread and inside its parent's interval."""
    step = _flow_step() if kind == "flow" else _interp_step()
    tracing.enable()
    step()
    recs = tracing.spans()
    names = [r.name for r in recs]
    want = _tree("flow_net.forward" if kind == "flow"
                 else "interp.forward", epe=kind == "flow")
    assert sorted(names) == sorted(want)
    got = {r.name: None if r.parent is None else recs[r.parent].name
           for r in recs}
    assert got == want
    assert {r.thread for r in recs} == {threading.get_ident()}
    for r in recs:
        assert r.end_ns is not None and r.start_ns <= r.end_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_exception_closes_the_span():
    """A span left by an exception is closed, and the next span is a
    root again."""
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError("left")
    with tracing.span("after"):
        pass
    outer, inner, after = tracing.spans()
    assert (outer.parent, inner.parent, after.parent) == (None, 0, None)
    assert all(r.end_ns is not None for r in (outer, inner, after))
    assert inner.end_ns <= outer.end_ns <= after.start_ns


def test_store_is_bounded(monkeypatch):
    """Past MAX_RECORDS a span is not recorded and is counted dropped."""
    monkeypatch.setattr(tracing, "MAX_RECORDS", 2)
    before = tracing.counts().get("tracing.dropped", 0)
    tracing.enable()
    for _ in range(3):
        with tracing.span("s"):
            pass
    assert len(tracing.spans()) == 2
    assert tracing.counts()["tracing.dropped"] == before + 1


def test_spans_on_the_profiler_clock():
    """Under a CPU torch.profiler session each span is a qpwcnet.<name>
    range, and its stored interval shifted by offset_ns() lies within
    100 us of that range."""
    from torch.profiler import ProfilerActivity, profile

    model = build_flow_net(0, "cpu")
    ims = torch.zeros((1, H, W, 6))
    tracing.enable()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p:
        model(ims)
    ranges = {e.name(): e for e in p.profiler.kineto_results.events()
              if e.name().startswith(tracing.PREFIX)}
    recs = tracing.spans()
    assert len(recs) == len(FORWARD) + 1
    off = tracing.offset_ns()
    assert off is not None
    for r in recs:
        e = ranges[tracing.PREFIX + r.name]
        assert abs(r.start_ns + off - e.start_ns()) < 100_000, r.name
        end = e.start_ns() + e.duration_ns()
        assert abs(r.end_ns + off - end) < 100_000, r.name


def test_launch_counts_are_counters():
    """launch_counts() reads the counters launches.<wrapper>, under every
    wrapper's name, and reset_launch_counts() zeroes those alone."""
    tracing.count("other")
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        fn.__name__: 0 for fn in kernels.KERNEL_WRAPPERS}
    tracing.count("launches.cost_volume_cuda", 3)
    tracing.count("launches.upconv_stage_cuda")
    counts = kernels.launch_counts()
    assert counts["cost_volume_cuda"] == 3
    assert counts["upconv_stage_cuda"] == 1
    assert tracing.counts()["launches.cost_volume_cuda"] == 3
    other = tracing.counts()["other"]
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert tracing.counts()["other"] == other


def test_threads_keep_their_own_stacks():
    """Eight threads, switching every microsecond, each open nested
    spans and count: every count is kept and every inner span's parent
    is its own thread's outer span."""
    n, reps = 8, 200
    tracing.reset_counts(["stress"])
    tracing.enable()

    def work():
        for _ in range(reps):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    tracing.count("stress")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tracing.counts()["stress"] == n * reps
    recs = tracing.spans()
    assert len(recs) == 2 * n * reps
    for r in recs:
        if r.name == "inner":
            p = recs[r.parent]
            assert p.name == "outer" and p.thread == r.thread
        else:
            assert r.parent is None
