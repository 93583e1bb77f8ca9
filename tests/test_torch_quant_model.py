"""The port's quantized models on CPU against the JAX package's: the QAT
flow net and interpolator (forward and range EMAs), one QAT flow train
step and one QAT pretraining step (loss, gradients, ranges), the int8
flow net (exact and 'fast'), BatchNorm recalibration of a QAT model, and
the builders that refuse the fused kernels with quant.

The same Flax tree (params, batch_stats and the zero-initialized
quant_stats) goes into both models. Quantization makes the comparison
discontinuous: where a value sits on a rounding boundary of a fake quant
(an output that sums in another order than XLA's; an input x / scale
that XLA's division rounds otherwise), the two sides land one code
apart, and train-mode BatchNorm over the few pixels of the coarse levels
amplifies such a difference downstream. So the models are checked conv
by conv: every quantized conv of the JAX forward is recorded (input,
ranges before and after, output) and the port's conv is run on JAX's
input from JAX's ranges (``_teacher_forced``). The ranges it updates
must agree to one float32 ulp (2.5e-7 relative: the first update, the
batch absmax, is exact; XLA contracts the EMA's multiply-add into an
FMA), the output ranges to that plus the rounding of the output whose
maximum they are (4e-7). Each output must equal JAX's to float32
rounding (2e-5 of its magnitude), except where a code flipped: such an
output may move by one output quantum plus one input code times the
largest weight at each tap, and there may be no more of them than two
flipped input codes reach plus FLIP_SHARE of the outputs. End to end
and in the train steps the bounds are stated at each check, beside what
was measured.
"""

import dataclasses
import inspect

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qpwcnet_torch.layout import CHANNELS_LAST
from qpwcnet_torch.models import (
    build_flow_net,
    build_interpolator,
    load_flax_variables,
)
from qpwcnet_torch.models.from_flax import (
    _module_path,
    to_flax_quant_stats,
    to_flax_tree,
    torch_key,
)
from qpwcnet_torch.quantize import QTensor, QuantConfig
from qpwcnet_torch.train import (
    make_flow_train_step,
    make_interp_train_step,
    plain_optimizer,
    recalibrate_batch_stats,
)
from qpwcnet_tpu.models.pwcnet import PWCFlowNet as JPWCFlowNet
from qpwcnet_tpu.models.pwcnet import PWCInterpolator as JPWCInterpolator
from qpwcnet_tpu.quantize import QConv as JQConv
from qpwcnet_tpu.quantize import QConvTranspose as JQConvTranspose
from qpwcnet_tpu.quantize import QuantConfig as JQuantConfig
from qpwcnet_tpu.quantize.qtensor import QTensor as JQTensor
from qpwcnet_tpu.train import create_flow_train_state
from qpwcnet_tpu.train import create_interp_train_state
from qpwcnet_tpu.train import make_flow_train_step as j_flow_step
from qpwcnet_tpu.train import make_interp_train_step as j_interp_step
from qpwcnet_tpu.train.agc import zero_nan_grads as j_zero_nan_grads
from tests.conftest import TEST_HW
from tests.test_torch_model import (
    _seeded,
    one_torch_thread,  # noqa: F401
)
from tests.test_torch_train import LR, _leaves, _np_tree, _recording

H, W = TEST_HW
QAT, INT8 = QuantConfig(), QuantConfig(mode="int8")
J_QAT, J_INT8 = JQuantConfig(), JQuantConfig(mode="int8")
# the share of a conv's outputs that a code flip may move in the
# teacher-forced checks (module docstring)
FLIP_SHARE = 5e-3
_SIG = inspect.signature(JQConv.__call__)


def _variables(variables, port, seed=0, k=0.2):
    """The seeded float tree (small 'diag' flow heads: flows of ~1 px)
    with the port's zero quant_stats; loaded into ``port``."""
    v = _seeded(variables, "diag", seed=seed, k=k, hw=TEST_HW)
    v["quant_stats"] = to_flax_quant_stats(port)
    load_flax_variables(port, v)
    return v


def _inputs(seed, b=2, c=6):
    return np.random.RandomState(seed).uniform(
        -0.5, 0.5, (b, H, W, c)).astype(np.float32)


def _capture(module_j, variables, x, train):
    """The JAX forward (jitted) with every QConv / QConvTranspose call
    recorded: [(flax path, update_stats, emit_qtensor, input, quant_stats
    before, after, output)] in call order; returns (output, mutated
    collections or None, records)."""
    static = []

    def fwd(v, x):
        calls = []

        def icpt(next_fun, args, kwargs, ctx):
            mod = ctx.module
            if ctx.method_name != "__call__" or not isinstance(
                    mod, (JQConv, JQConvTranspose)):
                return next_fun(*args, **kwargs)
            b = _SIG.bind(mod, *args, **kwargs)
            b.apply_defaults()
            before = mod.variables["quant_stats"]
            out = next_fun(*args, **kwargs)
            static.append(("/".join(mod.path), bool(b.arguments[
                "update_stats"]), bool(b.arguments["emit_qtensor"])))
            calls.append((b.arguments["x"], before,
                          mod.variables["quant_stats"], out))
            return out

        with nn.intercept_methods(icpt):
            if train:
                out, mut = module_j.apply(
                    v, x, train=True,
                    mutable=["batch_stats", "quant_stats"])
            else:
                out, mut = module_j.apply(v, x, train=False), None
        return out, mut, calls

    out, mut, calls = jax.device_get(jax.jit(fwd)(variables,
                                                  jnp.asarray(x)))
    return out, mut, [s + c for s, c in zip(static, calls)]


def _t(a):
    """numpy / JAX NHWC (or a JAX QTensor) -> the port's NCHW."""
    if isinstance(a, JQTensor):
        return QTensor(_t(a.q), torch.tensor(np.asarray(a.scale)))
    a = np.asarray(a)
    t = torch.from_numpy(a.astype(np.float32) if a.dtype == jnp.bfloat16
                         else a.copy())
    if a.dtype == jnp.bfloat16:
        t = t.to(torch.bfloat16)
    return t.permute(0, 3, 1, 2).contiguous(memory_format=CHANNELS_LAST)


def _set_ranges(mod, stats):
    with torch.no_grad():
        mod.amax_in.copy_(torch.tensor(np.asarray(stats["amax_in"])))
        if "act_quant" in stats:
            mod.act_quant.amax.copy_(torch.tensor(np.asarray(
                stats["act_quant"]["amax"])))


def _teacher_forced(port, records) -> float:
    """Run each recorded conv of the port on JAX's input from JAX's
    ranges (module docstring); returns the largest share of a conv's
    outputs that a code flip moved."""
    mods = dict(port.named_modules())
    worst = 0.0
    for name, update, emit, x, before, after, want in records:
        mod = mods[torch_key(tuple(name.split("/")) + ("kernel",))[
            :-len(".weight")]]
        _set_ranges(mod, before)
        mod.train(update)
        with torch.no_grad():
            got = mod(_t(x), emit_qtensor=emit)
        a, b = mod.amax_in.numpy(), np.asarray(after["amax_in"])
        assert np.all(np.abs(a - b) <= 2.5e-7 * b), name
        q_out = 0.0
        if "act_quant" in after:
            a, b = float(mod.act_quant.amax), float(after["act_quant"]
                                                    ["amax"])
            assert abs(a - b) <= 4e-7 * b, (name, a, b)
            q_out = b / 127.0
        if update:
            # the forward again from JAX's updated ranges, so that a
            # one-ulp range difference moves no code
            _set_ranges(mod, after)
            mod.eval()
            with torch.no_grad():
                got = mod(_t(x), emit_qtensor=emit)
        assert isinstance(got, QTensor) == isinstance(want, JQTensor), name
        # what one flipped code moves an output by: one output quantum,
        # plus an input code times the largest weight at every tap
        q_in = (float(x.scale) if isinstance(x, JQTensor) else
                float(np.max(after["amax_in"])) / 127.0)
        taps = mod.weight.shape[-1] * mod.weight.shape[-2]
        flip = q_out + taps * q_in * float(mod.weight.abs().max())
        if isinstance(want, JQTensor):
            assert abs(float(got.scale) - float(want.scale)) <= \
                4e-7 * float(want.scale), name
            flip = flip / float(want.scale) + 1.0  # in codes
            got, want = got.q, np.asarray(want.q, np.float32)
            tol = 0.0
        else:
            want = np.asarray(want, np.float32)
            tol = 2e-5 * max(1.0, float(np.abs(want).max()))
        d = np.abs(got.permute(0, 2, 3, 1).float().numpy() - want)
        off = d > tol
        assert np.all(d[off] <= 1.01 * flip + tol), (name, d.max(), flip)
        # the outputs two flipped input codes reach, and 1e-3 of the rest
        reach = taps * (1 if mod.groups > 1 else mod.weight.shape[
            1 if mod.TRANSPOSE else 0])
        assert off.sum() <= 2 * reach + FLIP_SHARE * off.size, \
            (name, int(off.sum()), off.size)
        worst = max(worst, float(off.mean()))
    return worst


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.sqrt(np.sum((a - b) ** 2) / max(np.sum(b ** 2), 1e-30)))


# -------------------------------------------------------------- QAT forward

def test_qat_flow_net_matches_jax(flow_setup):
    """Two train-mode forwards (ranges from 0, then the EMA) conv by conv,
    the quant_stats tree (same leaves, same values after both), and the
    eval-mode flow end to end within 4x JAX's own one-ulp sensitivity."""
    _, variables = flow_setup
    port = build_flow_net(0, "cpu", quant=QAT)
    v = _variables(variables, port)
    jm = JPWCFlowNet(cv_impl="xla", quant=J_QAT)
    x = _inputs(1)
    for _ in range(2):
        _, mut, records = _capture(jm, v, x, train=True)
        assert len(records) == 69
        _teacher_forced(port, records)
        v = {"params": v["params"], **mut}
    assert records[0][4]["amax_in"] > 0  # the second pass ran the EMA
    load_flax_variables(port, v)
    assert _leaves(to_flax_quant_stats(port)).keys() == \
        _leaves(v["quant_stats"]).keys()
    port.eval()
    want, _, records = _capture(jm, v, x, train=False)
    _teacher_forced(port, records)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.mean(np.abs(want)) > 0.2
    # measured 0.7%: the eval-mode flips, no train-mode BatchNorm
    assert _rel(got, want) <= 0.03, _rel(got, want)


def test_qat_interpolator_matches_jax(interp_setup):
    """The QAT interpolator's train-mode forward conv by conv (84 convs:
    the shared encoder, decoder and Flower and the five image heads with
    their per-channel input ranges) and its eval-mode image end to end
    within 4x JAX's one-ulp sensitivity."""
    _, variables = interp_setup
    port = build_interpolator(0, "cpu", quant=QAT)
    v = _variables(variables, port, seed=3)
    jm = JPWCInterpolator(cv_impl="xla", quant=J_QAT)
    x = _inputs(2)
    _, mut, records = _capture(jm, v, x, train=True)
    assert len(records) == 84
    _teacher_forced(port, records)
    v = {"params": v["params"], **mut}
    load_flax_variables(port, v)
    port.eval()
    want = _capture(jm, v, x, train=False)[0]
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.mean(np.abs(want)) > 0.05
    assert _rel(got, want) <= 0.03, _rel(got, want)


# ---------------------------------------------------------------- train steps

def _check_step(got_loss, got_grads, got_ranges, want):
    """The port's step against JAX's, within what the forward's flips
    amplify to through the train-mode BatchNorms of the coarse levels
    (module docstring; measured 1.2e-3 / 2.3e-3 of the loss, 1.2% / 3.2%
    of the gradients, 11% / 22% of the worst leaf, 1.1% / 4.4% of the
    ranges for the flow / pretraining step): the loss within 1%, all
    gradients together within 10% (relative L2), each leaf within 50%
    of its rms, and each range within 10% of its largest channel's."""
    loss, grads, ranges = want
    assert abs(got_loss - loss) <= 1e-2 * abs(loss), (got_loss, loss)
    assert got_grads.keys() == grads.keys()
    size = np.sqrt(sum(np.sum(g ** 2) for g in grads.values()))
    total = np.sqrt(sum(np.sum((got_grads[k] - g) ** 2)
                        for k, g in grads.items()))
    assert total <= 0.1 * size, total / size
    for k, g in grads.items():
        assert np.sqrt(np.mean((got_grads[k] - g) ** 2)) <= \
            0.5 * np.sqrt(np.mean(g ** 2)), k
    assert got_ranges.keys() == ranges.keys()
    for k, r in ranges.items():
        assert np.max(r) > 0.0, k
        assert np.max(np.abs(got_ranges[k] - r)) <= 0.1 * np.max(r), k


def _jax_step(create, make_step, model_j, v, batch):
    tx = optax.chain(_recording(), j_zero_nan_grads(), optax.adam(LR))
    state = create(model_j, v, tx=tx)
    new, m = jax.jit(make_step())(state, {k: jnp.asarray(a)
                                           for k, a in batch.items()})
    return (float(m["loss"]), _leaves(_np_tree(new.opt_state[0])),
            _leaves(_np_tree(new.quant_stats)))


def test_qat_flow_train_step_matches_jax(flow_setup):
    """One QAT make_flow_train_step (plain chain; the ranges updated in
    the forward, from 0): loss, every gradient, every range."""
    _, variables = flow_setup
    port = build_flow_net(0, "cpu", quant=QAT)
    v = _variables(variables, port, seed=4)
    rng = np.random.RandomState(5)
    batch = {"ims": rng.uniform(-0.5, 0.5, (2, H, W, 6)).astype(np.float32),
             "flo": rng.uniform(-3, 3, (2, H, W, 2)).astype(np.float32)}
    runs = _jax_step(create_flow_train_state, j_flow_step,
                     JPWCFlowNet(cv_impl="xla", quant=J_QAT), v, batch)
    m = make_flow_train_step()(port, plain_optimizer(port, LR), {
        k: torch.from_numpy(a) for k, a in batch.items()})
    _check_step(float(m["loss"]), _leaves(to_flax_tree(port, "grads")),
                _leaves(to_flax_quant_stats(port)), runs)


def test_qat_interp_train_step_matches_jax(interp_setup):
    """One QAT make_interp_train_step: loss, every gradient, every
    range."""
    _, variables = interp_setup
    port = build_interpolator(0, "cpu", quant=QAT)
    v = _variables(variables, port, seed=6)
    rng = np.random.RandomState(7)
    batch = {"ims": rng.uniform(-0.5, 0.5, (2, H, W, 6)).astype(np.float32),
             "mid": rng.uniform(-0.5, 0.5, (2, H, W, 3)).astype(np.float32)}
    runs = _jax_step(create_interp_train_state, j_interp_step,
                     JPWCInterpolator(cv_impl="xla", quant=J_QAT), v,
                     batch)
    m = make_interp_train_step()(port, plain_optimizer(port, LR), {
        k: torch.from_numpy(a) for k, a in batch.items()})
    _check_step(float(m["loss"]), _leaves(to_flax_tree(port, "grads")),
                _leaves(to_flax_quant_stats(port)), runs)


# --------------------------------------------------------------- int8 model

@pytest.fixture(scope="module")
def calibrated(flow_setup):
    """The seeded tree with ranges from two JAX QAT train-mode
    forwards."""
    _, variables = flow_setup
    v = _variables(variables, build_flow_net(0, "cpu", quant=QAT), seed=8)
    jm = JPWCFlowNet(cv_impl="xla", quant=J_QAT)
    apply = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats", "quant_stats"])[1])
    for seed in (10, 11):
        v = {"params": v["params"],
             **jax.device_get(apply(v, jnp.asarray(_inputs(seed))))}
    return v


@pytest.mark.parametrize("cv_impl", ["exact", "fast"])
def test_int8_flow_net_matches_jax(calibrated, cv_impl):
    """The int8 flow net (eval mode) conv by conv, QTensors and all (the
    DownConv and OptFlow chains, the per-channel folds, the transpose
    convs), and its flow end to end within 4x JAX's one-ulp sensitivity
    ('fast': the fused warp + correlation at the finest level, JAX's
    Pallas kernel in interpret mode)."""
    jm = JPWCFlowNet(cv_impl="xla" if cv_impl == "exact" else "fast",
                     quant=J_INT8)
    port = load_flax_variables(build_flow_net(
        0, "cpu", quant=INT8, cv_impl="auto" if cv_impl == "exact"
        else "fast"), calibrated)
    x = _inputs(12)
    want, _, records = _capture(jm, calibrated, x, train=False)
    assert len(records) == 69
    # the QTensor inputs: 10 of the DownConv chain (its first conv, the
    # image, is float), 4 x 5 of the OptFlow chains, 4 of the transposes
    # (the UpConvs take the dequantized concat: float), ...
    assert sum(isinstance(r[3], JQTensor) for r in records) == 34
    _teacher_forced(port, records)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.mean(np.abs(want)) > 0.2
    # the int8 products are exact: measured 5e-8
    assert _rel(got, want) <= 1e-5, _rel(got, want)


# ------------------------------------------------------------------- others

def test_recalibrate_keeps_ranges(calibrated):
    """recalibrate_batch_stats on a QAT model re-estimates the BatchNorm
    statistics and leaves the ranges as they were (JAX discards the
    mutated quant_stats); each pass quantizes with the ranges its own
    update gives, as JAX's does, so the statistics match JAX's to 1e-3
    (relative L2, a few flips through two passes)."""
    from qpwcnet_tpu.train import recalibrate_batch_stats as j_recal

    port = load_flax_variables(build_flow_net(0, "cpu", quant=QAT),
                               calibrated)
    ranges = {k: b.clone() for k, b in port.named_buffers()
              if "amax" in k}
    stats = {k: b.clone() for k, b in port.named_buffers()
             if "running" in k}
    batches = [_inputs(s) for s in (13, 14)]
    recalibrate_batch_stats(port, (torch.from_numpy(b) for b in batches), 2)
    assert not port.training
    for k, b in port.named_buffers():
        if k in ranges:
            assert torch.equal(b, ranges[k]), k
    assert any(not torch.equal(b, stats[k]) for k, b in port.named_buffers()
               if k in stats)

    jm = JPWCFlowNet(cv_impl="xla", quant=J_QAT)
    state = create_flow_train_state(jm, calibrated)
    want = _leaves(_np_tree(j_recal(state, iter(map(jnp.asarray, batches)),
                                    2).batch_stats))
    got = {}
    for k, b in port.named_buffers():
        if "running" in k:
            parts = k.split(".")
            mods = "".join(f"['{p}']" for p in _module_path(parts[:-1]))
            got[mods + ("['mean']" if parts[-1] == "running_mean"
                        else "['var']")] = b.numpy()
    assert got.keys() == want.keys()
    err = _rel(np.concatenate([got[k].ravel() for k in want]),
               np.concatenate([want[k].ravel() for k in want]))
    assert err <= 1e-3, err


def test_quant_refusing_builders():
    """JAX's refusals: the fused stem and upconv kernels are float-only
    (build_flow_net refuses stem_stages and upconv_stages with quant,
    build_interpolator stem_stages), and under quant the Decoder runs its
    UpConv modules; the port also refuses int8 under an H-sharded mesh.
    A float model's state_dict keys are those of the JAX tree's params
    and batch_stats; a quantized one adds the quant_stats leaves."""
    from qpwcnet_torch.parallel import SpatialConfig, make_mesh

    for kw in (dict(stem_stages=2), dict(upconv_stages=2)):
        with pytest.raises(ValueError):
            build_flow_net(0, "cpu", quant=QAT, **kw)
    with pytest.raises(ValueError):
        build_interpolator(0, "cpu", quant=QAT, stem_stages=2)
    m = build_interpolator(0, "cpu", quant=QAT, upconv_stages=2)
    assert m.decoder.upconv_stages == 0
    # int8 under an H-sharded mesh builds (tests/test_torch_quant_spatial.py
    # runs it), as in JAX
    sp = build_flow_net(0, "cpu", quant=INT8, spatial=SpatialConfig(
        make_mesh(n_data=1, n_model=2)))
    assert sp.flower.flow_0.spatial is not None
    f, q = build_flow_net(0, "cpu"), build_flow_net(0, "cpu", quant=QAT)
    assert len(f.state_dict()) == 133
    ranges = set(q.state_dict()) - set(f.state_dict())
    assert set(f.state_dict()) < set(q.state_dict())
    assert len(ranges) == 118 and all("amax" in k for k in ranges)
    assert dataclasses.replace(QAT, mode="int8") == INT8
