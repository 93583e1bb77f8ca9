"""The flow net's eval forward replayed as a CUDA graph
(``models/pwcnet.py:ForwardGraphs``).

On the CPU: which calls may take the graph. A CPU input, train mode,
gradients on, the H-sharded model, a quantized model and a
``torch.export`` of the flow net are all refused it and run the eager
forward. On a CUDA card (tests marked ``cuda``, skipped without one): the
replayed outputs are bit for bit the eager forward's, outputs returned
earlier outlive later replays, weights loaded in place reach the graph,
``.to()`` drops the graphs, a new shape captures its own, the counters
read one eager call, one capture and then replays, the kernel launch
counters count every call, and profiler sessions after a capture record
every kernel.

This file imports neither jax nor the JAX package; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_flow_graph.py
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qpwcnet_torch.models import build_flow_net
from qpwcnet_torch.utils import tracing

COUNTERS = ("flow_net.graph_eager", "flow_net.graph_captures",
            "flow_net.graph_replays")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread for the module's tests (as in
    tests/test_torch_model.py, which imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def graph_counts() -> tuple:
    c = tracing.counts()
    return tuple(c.get(k, 0) for k in COUNTERS)


def moved(before: tuple) -> tuple:
    return tuple(b - a for a, b in zip(before, graph_counts()))


# ----------------------------------------------------------------- CPU


def _cpu_model(**kw):
    return build_flow_net(0, "cpu", head_scale="unit", **kw)


def _cpu_input(h=64, w=64):
    g = torch.Generator().manual_seed(3)
    return torch.rand((1, h, w, 6), generator=g) - 0.5


def _run_cpu_input():
    model, x = _cpu_model(), _cpu_input()
    with torch.no_grad():
        assert not model._graphable(x)
        out = model(x)
        want = model._forward(x, False)
    assert torch.equal(out, want)
    return model


def _run_train():
    model, x = _cpu_model().train(), _cpu_input()
    with torch.no_grad():
        assert not model._graphable(x)
        model(x)
    return model


def _run_grad():
    model, x = _cpu_model(), _cpu_input()
    assert torch.is_grad_enabled() and not model._graphable(x)
    assert model(x).requires_grad
    return model


def _run_spatial():
    from qpwcnet_torch.parallel import (
        SpatialConfig,
        make_mesh,
        make_spatial_forward,
        shard_batch_spatial,
    )

    mesh = make_mesh(n_data=1, n_model=2)
    model = _cpu_model(spatial=SpatialConfig(mesh, warp_halo=16))
    x = shard_batch_spatial(_cpu_input(128, 64), mesh)
    with torch.no_grad():
        assert not model._graphable(x)
        out = make_spatial_forward(lambda m, t: m(t), mesh)(model, x)
    assert out.shape == (2, 64, 64, 2)
    return model


def _run_quant():
    from qpwcnet_torch.quantize.fake_quant import QuantConfig

    model, x = _cpu_model(quant=QuantConfig()), _cpu_input()
    with torch.no_grad():
        assert not model._graphable(x)
        model(x)
    return model


def _run_export():
    model, x = _cpu_model(), _cpu_input()
    decided = []
    graphable = model._graphable

    def spy(inputs):
        decided.append(graphable(inputs))
        return decided[-1]

    model._graphable = spy
    prog = torch.export.export(model, (x,))
    assert decided == [False]
    ops = [str(n.target) for n in prog.graph.nodes
           if n.op == "call_function"]
    # the eager forward was traced, every conv of it
    assert ops.count("aten.conv2d.default") == 65
    return model


EAGER_CASES = {"cpu_input": _run_cpu_input, "train": _run_train,
               "grad": _run_grad, "spatial": _run_spatial,
               "quant": _run_quant, "export": _run_export}


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_eager_paths_count_no_graph(case):
    """Each of these calls is refused the graph (``_graphable``) and runs
    today's eager forward."""
    EAGER_CASES[case]()


def test_copies_start_with_no_graph():
    """A deep copy or a pickle of the model holds its own empty cache
    (CUDA graphs cannot be copied)."""
    import pickle

    model = _cpu_model()
    for other in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert other.graphs is not model.graphs
        assert other.graphs.name == "flow_net" and len(other.graphs) == 0


# ---------------------------------------------------------------- card

H, W, B = 448, 1024, 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU build")
    return torch.device("cuda", 0)


def _seed_heads(model, seed, hw=(H, W)):
    """Non-zero flow heads ('diag' heads start at 0, and every flow with
    them), flows of about a pixel at every level."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for i, up in enumerate([model.flower.flow_0,
                                *model.flower.upflows]):
            s = float(np.hypot(hw[0] >> (5 - i), hw[1] >> (5 - i)))
            w = up.flow.of_flow.weight
            w.copy_(torch.from_numpy(rng.standard_normal(w.shape)
                                     .astype(np.float32) * 10 / s))


def _model(dev, seed=0):
    """The benchmark's configuration: bf16, K2 on stages 0-1, K1."""
    model = build_flow_net(seed, dev, dtype=torch.bfloat16, stem_stages=2)
    _seed_heads(model, seed + 100)
    return model


def _inputs(dev, n=4, hw=(H, W), seed=11):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.rand((B, *hw, 6), generator=g, device=dev) - 0.5
            for _ in range(n)]


def _eager(model, x, multiscale=False):
    with torch.no_grad():
        return model._forward(x, multiscale)


def _same(got, want):
    if isinstance(want, list):
        return len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
    return torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("multiscale", [False, True])
@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_replay_is_bit_for_bit_eager(dev, multiscale, mode):
    """Over 4 distinct inputs, cycled twice: the eager call, the capture
    and every replay equal the eager forward of their input; the first
    two calls run under inference_mode, the rest under ``mode``."""
    model, xs = _model(dev), _inputs(dev)
    want = [_eager(model, x, multiscale) for x in xs]
    assert float(want[0][-1].abs().mean() if multiscale
                 else want[0].abs().mean()) > 0.1
    ctx = {"inference_mode": torch.inference_mode,
           "no_grad": torch.no_grad}[mode]
    for i in range(2 * len(xs)):
        with (torch.inference_mode() if i < 2 else ctx()):
            got = model(xs[i % len(xs)], multiscale=multiscale)
        assert _same(got, want[i % len(xs)]), i
    assert len(model.graphs) == 1


@pytest.mark.cuda
def test_counters_read_one_eager_one_capture_then_replays(dev):
    """And the kernel wrappers' launch counters count each of the n
    calls' kernels, the replays' too."""
    from qpwcnet_torch.ops import cuda as kernels

    model, xs = _model(dev), _inputs(dev)
    n = 7
    kernels.reset_launch_counts()
    with torch.no_grad():
        model._forward(xs[0], False)
    per = kernels.launch_counts()
    assert per["cost_volume_cuda"] == 5 and per["bias_mish_cuda"] == 38
    kernels.reset_launch_counts()
    before = graph_counts()
    with torch.inference_mode():
        for i in range(n):
            model(xs[i % len(xs)])
    torch.cuda.synchronize()
    assert moved(before) == (1, 1, n - 2)
    assert kernels.launch_counts() == {k: n * v for k, v in per.items()}


@pytest.mark.cuda
def test_outputs_outlive_later_replays(dev):
    """Two calls in flight, as the closed loop keeps them: an output
    returned earlier is unchanged after later replays (each call returns
    a copy of the static output)."""
    model, xs = _model(dev), _inputs(dev)
    want = [_eager(model, x) for x in xs]
    with torch.inference_mode():
        model(xs[0])
        model(xs[1])           # eager, then the capture
        outs = []
        for i in range(8):
            outs.append(model(xs[i % len(xs)]))
            if len(outs) >= 2:  # a held output, two replays later
                assert _same(outs[-2], want[(i - 1) % len(xs)])
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert _same(out, want[i % len(xs)]), i


@pytest.mark.cuda
def test_load_state_dict_reaches_the_graph(dev):
    """load_state_dict copies into the tensors the graph reads: the next
    replay is the eager forward of the new weights, with no new
    capture."""
    model, xs = _model(dev), _inputs(dev)
    with torch.inference_mode():
        for x in xs[:3]:
            model(x)
    other = _model(dev, seed=5)
    model.load_state_dict(other.state_dict())
    want = _eager(other, xs[3])
    assert not torch.equal(want, _eager(_model(dev), xs[3]))
    before = graph_counts()
    with torch.inference_mode():
        got = model(xs[3])
    assert moved(before) == (0, 0, 1)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_to_drops_the_graphs(dev):
    model, xs = _model(dev), _inputs(dev, n=2)
    with torch.inference_mode():
        model(xs[0])
        model(xs[1])
    assert len(model.graphs) == 1
    model.to(dev)
    assert len(model.graphs) == 0
    before = graph_counts()
    with torch.inference_mode():
        got = model(xs[0])
    assert moved(before) == (1, 0, 0)
    assert torch.equal(got, _eager(model, xs[0]))


@pytest.mark.cuda
def test_profiler_sessions_after_a_capture_keep_every_kernel(dev):
    """After a capture, each torch.profiler session records the graph's
    kernels and every kernel launched on its own, the first one too
    (CUPTI's teardown between sessions would drop it). Checked in a fresh
    process (this file run as a script): torch.profiler loses short
    windows' device records once a process has run much other card work,
    with or without graphs (PERF.md §7)."""
    root = Path(__file__).resolve().parents[1]
    path = os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")])
    res = subprocess.run([sys.executable, __file__], cwd=root,
                         env={**os.environ, "PYTHONPATH": path},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]


def _profiler_sessions_after_a_capture(dev):
    from torch.profiler import ProfilerActivity, profile

    model, xs = _model(dev), _inputs(dev, n=2, hw=(128, 256))
    a = torch.rand(1000, device=dev)

    def kernels(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    with torch.inference_mode():
        model(xs[0])
        eager = len(kernels(lambda: model._forward(xs[0], False)))
        model(xs[1])
        before = graph_counts()
        replayed = kernels(lambda: model(xs[0]))
        assert moved(before) == (0, 0, 1)
    # the replay adds the input copy and the clone (Memcpy records)
    assert len(replayed) == eager + 2
    for _ in range(3):
        assert len(kernels(lambda: a * 2)) == 1


@pytest.mark.cuda
def test_new_shape_captures_a_new_graph(dev):
    """A second input shape runs eagerly, captures and replays on its
    own, and the first shape's graph still replays."""
    model = _model(dev)
    big, small = _inputs(dev, n=2), _inputs(dev, n=2, hw=(256, 512))
    with torch.inference_mode():
        model(big[0])
        model(big[1])
        before = graph_counts()
        outs = [model(small[i % 2]) for i in range(3)]
        assert moved(before) == (1, 1, 1)
        assert len(model.graphs) == 2
        before = graph_counts()
        again = model(big[0])
        assert moved(before) == (0, 0, 1)
    for i, out in enumerate(outs):
        assert torch.equal(out, _eager(model, small[i % 2])), i
    assert torch.equal(again, _eager(model, big[0]))


if __name__ == "__main__":
    _profiler_sessions_after_a_capture(torch.device("cuda", 0))
