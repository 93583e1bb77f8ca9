"""perfbench/phases.py on made-up profiler events and span records:
kernels and their device time attributed to the innermost program span
that held their launch (joined by correlation id, on any thread), idle
gaps labelled with the benchmark span and the program span over them,
and the spans' host times."""

import pytest
import torch

from perfbench import phases, trace
from qpwcnet_torch.utils.tracing import Record

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, t0_us, t1_us, corr=0):
        self._n, self._d, self._t0, self._t1 = name, dev, t0_us, t1_us
        self._c = corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._t0 * 1000)

    def duration_ns(self):
        return int((self._t1 - self._t0) * 1000)

    def correlation_id(self):
        return self._c


EW = "void at::native::vectorized_elementwise_kernel<4, Mul>(...)"


def events():
    ranges = [(trace.SUBWINDOW, 0, 100),
              ("perfbench.step_enqueue", 0, 60),
              ("perfbench.wait_step", 60, 100),
              ("qpwcnet.train_step", 1, 58),
              ("qpwcnet.step.forward", 2, 20),
              ("qpwcnet.encoder", 3, 10),
              ("qpwcnet.step.backward", 21, 40),
              ("qpwcnet.step.optimizer", 41, 57),
              ("qpwcnet.opt.adam", 45, 56)]
    # corr 3 is launched by autograd's thread while the caller waits in
    # step.backward; corr 5 after the step, inside the benchmark's call
    launches = [(1, 4), (2, 15), (3, 30), (4, 50), (5, 59)]
    kernels = [("void qpw::cost_volume_mma_kernel<8, 1>(...)", 10, 20, 1),
               (EW, 20, 25, 2), (EW, 30, 45, 3),
               ("void multi_tensor_apply_kernel<Adam>(...)", 50, 52, 4),
               (EW, 60, 70, 5), ("Memcpy HtoD", 26, 28, 6)]
    return ([Ev(n, CPU, a, b) for n, a, b in ranges]
            + [Ev("cudaLaunchKernel", CPU, t, t + 1, c) for c, t in launches]
            + [Ev("cudaMemcpyAsync", CPU, 24, 25, 6)]
            + [Ev("qpwcnet.step.forward", CUDA, 2, 20)]
            + [Ev(n, CUDA, a, b, c) for n, a, b, c in kernels])


def test_attribute_launches_and_device_time():
    got = phases.attribute(events(), units=1)
    assert got["kernels_per_unit"] == 5
    inner = {k: v["self"] for k, v in got["launches"].items() if v["self"]}
    assert inner == {"encoder": 1, "step.forward": 1, "step.backward": 1,
                     "opt.adam": 1, phases.OUTSIDE: 1}
    total = {k: v["total"] for k, v in got["launches"].items()
             if v["total"]}
    assert total == {"train_step": 4, "step.forward": 2, "encoder": 1,
                     "step.backward": 1, "step.optimizer": 1, "opt.adam": 1}
    # the step's phases and what lies outside every span make up the unit
    assert sum(total[k] for k in ("step.forward", "step.backward",
                                  "step.optimizer")) \
        + inner[phases.OUTSIDE] == got["kernels_per_unit"]
    ms = got["device_ms"]
    assert ms["encoder"]["self"] == pytest.approx(0.010)
    assert ms["step.backward"]["total"] == pytest.approx(0.015)
    assert ms["step.optimizer"]["total"] == pytest.approx(0.002)
    assert ms["train_step"]["total"] == pytest.approx(0.032)


def test_attribute_labels_gaps():
    got = phases.attribute(events(), units=1)
    idle = got["idle_ms"]
    # 0-10: train_step overlaps it most (9 us); 25-26 and 28-30: the
    # backward ties train_step and is the innermost; 45-50: opt.adam ties
    # train_step and step.optimizer; 52-60: train_step (6 us); 70-100:
    # no program span
    assert idle == pytest.approx({
        "step_enqueue/train_step": 0.010 + 0.008,
        "step_enqueue/step.backward": 0.003,
        "step_enqueue/opt.adam": 0.005,
        "wait_step": 0.030})
    assert got["idle_gaps_ms"][0] == ["wait_step", pytest.approx(0.030)]
    assert got["idle_pct"] == pytest.approx(100 - 44)


def test_attribute_keeps_the_subwindow_numbers():
    """The same events reduce to the same kernel count and busy time in
    trace.reduce_events as in the attribution."""
    sub = trace.reduce_events(events(), units=1)
    got = phases.attribute(events(), units=1)
    assert sub.n_kernels == got["kernels_per_unit"]
    assert 100 * (1 - sub.busy_s / sub.window_s) == \
        pytest.approx(got["idle_pct"])


def test_attribute_without_a_subwindow():
    assert phases.attribute([e for e in events()
                             if e.name() != trace.SUBWINDOW], 1) is None


def test_host_ms():
    ms = 1_000_000
    recs = [Record("train_step", None, 1, 0, 10 * ms),
            Record("step.forward", 0, 1, 1 * ms, 4 * ms),
            Record("step.backward", 0, 1, 5 * ms, 9 * ms),
            Record("train_step", None, 1, 20 * ms, 32 * ms),
            Record("step.forward", 3, 1, 21 * ms, 26 * ms),
            Record("step.backward", 3, 1, 26 * ms, 31 * ms)]
    got = phases.host_ms(recs, units=2)
    assert got["train_step"]["ms_per_unit"] == pytest.approx(11)
    assert got["train_step"]["self_ms_per_unit"] == pytest.approx(2.5)
    assert got["step.forward"]["median_ms"] == pytest.approx(4)
    assert got["step.backward"]["per_unit"] == 1
