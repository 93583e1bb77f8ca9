"""The reduction of a profiled sub-window, on made-up profiler events:
busy time as the union of device intervals, idle gaps labelled with the
benchmark span that covered them, dropped records refused, and the
per-layer readers on the result."""

import pytest
import torch

from perfbench import readers, trace
from perfbench.loop import Window
from perfbench.trace import Spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, t0_us, t1_us):
        self._n, self._d, self._t0, self._t1 = name, dev, t0_us, t1_us

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._t0 * 1000)

    def duration_ns(self):
        return int((self._t1 - self._t0) * 1000)


K1 = "void qpw::cost_volume_mma_kernel<8, 1>(...)"
EW = "void at::native::vectorized_elementwise_kernel<4, Mul>(...)"


def events(drop=False):
    evs = [Ev(trace.SUBWINDOW, CPU, 0, 100),
           Ev("perfbench.forward_enqueue", CPU, 0, 30),
           Ev("perfbench.forward_enqueue", CPU, 50, 80),
           Ev("perfbench.wait_batch", CPU, 80, 100),
           Ev("cudaLaunchKernel", CPU, 1, 2)]
    # batch 1: 10-20 K1, 20-25 elementwise; batch 2: 60-70 K1, 72-90
    kernels = [(K1, 10, 20), (EW, 20, 25), (K1, 60, 70), (EW, 72, 90)]
    if drop:
        kernels = kernels[:-1]
    # the device timeline's copy of a host range is no device operation
    annotation = Ev("perfbench.forward_enqueue", CUDA, 0, 100)
    return evs + [annotation] + [Ev(n, CUDA, a, b) for n, a, b in kernels]


def test_reduce():
    sub = trace.reduce_events(events(), units=2)
    assert sub.window_s == pytest.approx(100e-6)
    assert sub.busy_s == pytest.approx(43e-6)
    assert sub.n_kernels == 4
    assert sub.by_category()["K1"] == pytest.approx(20e-6)
    labels = dict(sub.idle)
    # 25-60 is mostly under no span but overlaps the first enqueue 25-30
    # and the second 50-60 (10 us): the longest overlap labels it
    assert sub.idle[0] == ("forward_enqueue", pytest.approx(35e-6))
    assert labels["wait_batch"] == pytest.approx(10e-6)      # 90-100
    bd = sub.breakdown()
    assert [n for n, _ in bd["device_ops"]] == [
        "elementwise: at::native::vectorized_elementwise_kernel",
        "K1: qpw::cost_volume_mma_kernel"]
    assert len(bd["idle_gaps"]) <= 10


def test_dropped_records_are_refused():
    assert trace.reduce_events(events(drop=True), units=2) is None


def test_readers():
    sub = trace.reduce_events(events(), units=2)
    spans = Spans()
    spans.by_name["forward_enqueue"] = [0.010, 0.030, 0.020]
    ctx = readers.Context(window=Window(units=10, seconds=2.0, spans=spans),
                          sub=sub, enqueue_span="forward_enqueue",
                          flops_per_unit=989e12 * 0.02,
                          bounds={"K1": 5e-6})
    assert readers.enqueue_ms(ctx) == pytest.approx(20.0)
    assert readers.launches_per_unit(ctx) == 2
    assert readers.elementwise_ms(ctx) == pytest.approx(23e-6 * 1e3 / 2)
    assert readers.kernels_roofline_pct(ctx) == pytest.approx(50.0)
    assert readers.mfu_pct(ctx) == pytest.approx(10.0)
    assert readers.idle_pct(ctx) == pytest.approx(57.0)
    ctx.sub = None
    assert readers.kernels_roofline_pct(ctx) is None
    assert readers.idle_pct(ctx) is None


def test_union_and_gaps():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [
        (0, 1), (3, 5), (6, 7)]
