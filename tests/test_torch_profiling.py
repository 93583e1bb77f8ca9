"""The port's profiling tools and the pretraining app's --debug-nan on CPU,
against the JAX package where it has a counterpart:

  * summarize_model: the parameter total of the default flow net
    (3,094,005) and each top-level module's total, as JAX's tree of the
    same model's Flax parameters;
  * cost_analysis: the flow net's forward flops within a stated band of
    XLA's figure (the port counts the SAME padding's zero taps, which XLA
    leaves out), and the bytes of one lone conv exactly equal to XLA's;
  * time_fn / time_fn_chained / trace: a smoke run on the CPU;
  * the show_network app on --device cpu;
  * --debug-nan: the losses of two steps equal to the run without it, and
    FloatingPointError at a NaN pixel, as JAX raises under
    ``jax.debug_nans`` (held here on the loss that takes the NaN: JAX's
    whole pretraining step, which ``debug_nans`` re-runs op by op, would
    take minutes on the CPU).
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.apps import pretrain_interp, show_network
from qpwcnet_torch.models import build_flow_net, build_interpolator
from qpwcnet_torch.train import (
    create_interp_train_state,
    make_interp_train_step,
    multiscale_interp_loss,
)
from qpwcnet_torch.utils.profiling import (
    cost_analysis,
    summarize_model,
    time_fn,
    time_fn_chained,
    trace,
)
from qpwcnet_tpu.train import multiscale_interp_loss as j_interp_loss
from qpwcnet_tpu.utils.profiling import cost_analysis as j_cost_analysis
from qpwcnet_tpu.utils.profiling import summarize_model as j_summarize
from tests.test_torch_model import one_torch_thread  # noqa: F401

HW = (64, 128)
# the flow net's flops over XLA's at 64x128: measured 1.0386 (the zero
# taps of the SAME padding, which XLA's figure leaves out); XLA's figure
# is a floor
FLOP_BAND = (1.0, 1.06)


def _top_level(summary: str) -> dict:
    return {m.group(1): int(m.group(2).replace(",", ""))
            for m in re.finditer(r"^  (\w+): ([\d,]+)$", summary, re.M)}


def test_summarize_model_matches_jax(flow_setup):
    """The same totals as JAX's tree of the Flax parameters: 3,094,005 in
    all, and each of encoder, decoder and flower."""
    _, variables = flow_setup
    want = j_summarize(variables["params"])
    got = summarize_model(build_flow_net(0, "cpu"))
    assert got.splitlines()[-1] == want.splitlines()[-1] == \
        "TOTAL: 3,094,005 params"
    assert _top_level(got) == _top_level(want)
    assert set(_top_level(got)) == {"encoder", "decoder", "flower"}
    assert got.splitlines()[0] == "model: 3,094,005"
    assert re.search(r"^ +weight: \(16, 3, 3, 3\) = 432$", got, re.M)


def test_cost_analysis_flops_within_band_of_xla(flow_setup):
    """The eval forward's flops at 64x128 b1: FlopCounterMode counts the
    convs' multiply-adds (the kernels' plain versions on the CPU add
    none) within FLOP_BAND of XLA's figure; its bytes, over the unfused
    ATen ops, are above XLA's."""
    model, variables = flow_setup
    x = np.zeros((1, *HW, 6), np.float32)
    want = j_cost_analysis(lambda v, ims: model.apply(v, ims, train=False),
                           variables, jnp.asarray(x))
    port = build_flow_net(0, "cpu")
    got = cost_analysis(lambda ims: port(ims), torch.from_numpy(x))
    assert set(got) == {"flops", "bytes accessed"}
    ratio = got["flops"] / want["flops"]
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio
    assert got["bytes accessed"] >= want["bytes accessed"]


def test_cost_analysis_bytes_of_a_lone_conv_equal_xla():
    """A lone 3x3 SAME conv: the bytes (input + kernel + output; the
    layout permutes are views and move none) exactly XLA's, and the flops
    the counter's 2·9·Ci·Co a pixel (XLA's leave out the zero taps of the
    border: at most that)."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 16, 24, 8)).astype(np.float32)
    k = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    want = j_cost_analysis(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x), jnp.asarray(k))
    got = cost_analysis(
        lambda a, b: torch.nn.functional.conv2d(
            a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1),
        torch.from_numpy(x), torch.from_numpy(k))
    out = 2 * 16 * 24 * 16
    assert got["bytes accessed"] == want["bytes accessed"] == \
        4 * (x.size + k.size + out)
    assert want["flops"] <= got["flops"] == 2 * out * 9 * 8


def test_time_fn_and_trace_on_cpu(tmp_path):
    """time_fn: the median of positive host times; time_fn_chained over a
    pytree argument (only its floating leaves are scaled); trace: a
    Chrome trace JSON in the directory naming the ops that ran."""
    x = torch.ones(64, 64)
    calls = []

    def f(a):
        calls.append(1)
        return a @ a

    t = time_fn(f, x, iters=5, warmup=2)
    assert t > 0 and len(calls) == 7
    seen = []

    def g(tree):
        seen.append(tree)
        return {"y": tree["x"] * 2.0}

    tree = {"x": torch.ones(8), "n": torch.arange(3)}
    assert time_fn_chained(g, tree, iters=3) > 0
    assert len(seen) == 4
    assert torch.equal(seen[-1]["n"], tree["n"])
    assert float(seen[-1]["x"][0]) > float(seen[-2]["x"][0]) > 1.0
    with trace(str(tmp_path / "tr")):
        f(x)
    (path,) = (tmp_path / "tr").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("model", ["flow", "interp"])
def test_show_network_on_cpu(capsys, tmp_path, model):
    """The app prints the parameter tree, GFLOP and MB a forward, the
    forward's ms and TFLOP/s, and writes the trace; its numbers are
    cost_analysis's and summarize_model's."""
    out = show_network.main(["--model", model, "--height", "32", "--width",
                             "64", "--device", "cpu", "--trace-dir",
                             str(tmp_path)])
    said = capsys.readouterr()
    build = build_flow_net if model == "flow" else build_interpolator
    summary = summarize_model(build(0, "cpu"))
    assert said.out.startswith(summary + "\n")
    assert f"{out['flops'] / 1e9:.2f} GFLOP/forward" in said.out
    assert "TFLOP/s achieved" in said.out and out["forward_s"] > 0
    assert out["params"] == int(summary.splitlines()[-1].split()[1]
                                .replace(",", ""))
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert traces
    assert any(e.get("name") == "qpwcnet.flower" for e in
               json.loads(traces[0].read_text())["traceEvents"])
    assert "trace written to" in said.err


APP_ARGS = ["--batch-size", "2", "--height", "32", "--width", "64",
            "--device", "cpu", "--log-every", "1", "--recalibrate-final",
            "0", "--ckpt-every", "100", "--steps", "2"]


def _logged_losses(run_dir) -> list:
    lines = (run_dir / "log" / "metrics.jsonl").read_text().splitlines()
    return [json.loads(s) for s in lines]


def test_debug_nan_losses_equal_the_run_without(tmp_path):
    """pretrain_interp --debug-nan true: two steps whose logged losses
    equal those of the run without the flag, bit for bit (anomaly mode
    and the checks change no arithmetic)."""
    pretrain_interp.main(APP_ARGS + ["--run-root", str(tmp_path / "a")])
    pretrain_interp.main(APP_ARGS + ["--run-root", str(tmp_path / "b"),
                                     "--debug-nan", "true"])
    a = _logged_losses(tmp_path / "a" / "000")
    b = _logged_losses(tmp_path / "b" / "000")
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert {k: v for k, v in x.items() if "per_sec" not in k and
                k != "time"} == {k: v for k, v in y.items()
                                 if "per_sec" not in k and k != "time"}


def _nan_batch():
    rng = np.random.RandomState(0)
    ims = rng.uniform(-0.5, 0.5, (2, 32, 64, 6)).astype(np.float32)
    mid = rng.uniform(-0.5, 0.5, (2, 32, 64, 3)).astype(np.float32)
    ims[1, 5, 9, 2] = np.nan
    return ims, mid


def test_debug_nan_raises_at_a_nan_pixel():
    """A NaN pixel of the input: the debug step raises FloatingPointError
    before the optimizer (the parameters stay as they were); the step
    without the flag scrubs the NaN gradients and goes on. JAX under
    ``jax.debug_nans`` raises FloatingPointError on the same NaN reaching
    the pretraining loss."""
    ims, mid = _nan_batch()
    batch = {"ims": torch.from_numpy(ims), "mid": torch.from_numpy(mid)}
    model = build_interpolator(0, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    chain = create_interp_train_state(model, 1e-4)
    with pytest.raises(FloatingPointError,
                       match="NaN in forward output of encoder"):
        make_interp_train_step(debug_nan=True)(model, chain, batch)
    assert all(torch.equal(before[k], v) for k, v in
               model.named_parameters())
    assert chain.global_step == 0
    m = make_interp_train_step()(model, chain, batch)
    assert torch.isnan(m["loss"]) and chain.global_step == 1

    preds = [np.full((2, 32 >> i, 64 >> i, 3), 0.1, np.float32)
             for i in range(3)]
    preds[0][1, 2, 3, 0] = np.nan
    with jax.debug_nans(True), pytest.raises(FloatingPointError):
        j_interp_loss(jnp.asarray(mid), [jnp.asarray(p) for p in preds])
    got, _ = multiscale_interp_loss(torch.from_numpy(mid),
                                    [torch.from_numpy(p) for p in preds])
    assert torch.isnan(got)
