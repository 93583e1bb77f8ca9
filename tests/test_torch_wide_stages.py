"""The fully fused configuration on CPU: K2 at encoder stages 3-4 and K5
at decoder stages 0-1 (the widths the card runs through the implicit
GEMM of csrc/conv_gemm.cuh), and the models with ``stem_stages=5,
upconv_stages=4``, against the JAX package.

The JAX side runs its stem and upconv Pallas kernels in interpret mode,
as tests/test_stem_kernel.py and tests/test_upconv_kernel.py do; the
port's wrappers take their plain versions on CPU tensors. Inputs come
from numpy seeds. Tolerances: float32 sums in another order, 1e-5 of the
magnitude for one stage (1e-5 for d_x and 1e-4 for the parameter
gradients, the JAX tests' bounds); the whole models, 1e-4 of the flow
magnitude (tests/test_torch_model.py's parity bound); a train step's
gradients, 1e-4 of each leaf's max (tests/test_torch_train.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.models import (
    build_flow_net,
    build_interpolator,
    load_flax_variables,
)
from qpwcnet_torch.models.from_flax import to_flax_tree
from qpwcnet_torch.models.pwcnet import DECODER_FILTERS, ENCODER_FILTERS
from qpwcnet_torch.ops.cuda import stem_kernel, upconv_kernel
from qpwcnet_torch.ops.cuda.stem_kernel import (
    STEM_CHANNELS,
    STEM_MAX_CI_BF16,
    downconv_stage_cuda,
    downconv_stage_plain,
    downconv_stage_trainable,
)
from qpwcnet_torch.ops.cuda.upconv_kernel import (
    UPCONV_CHANNELS,
    UPCONV_MAX_CI_BF16,
    upconv_stage_cuda,
    upconv_stage_plain,
    upconv_stage_trainable,
)
from qpwcnet_torch.train import make_flow_train_step, plain_optimizer
from qpwcnet_tpu.ops.pallas.stem_kernel import (
    downconv_stage_pallas,
    downconv_stage_trainable as j_downconv_stage_trainable,
)
from qpwcnet_tpu.ops.pallas.upconv_kernel import (
    upconv_stage_pallas,
    upconv_stage_trainable as j_upconv_stage_trainable,
)
from tests.conftest import TEST_HW
from tests.test_torch_kernels_plain import _stage as _down_stage
from tests.test_torch_model import (
    _err,
    _inputs,
    _seeded,
    one_torch_thread,  # noqa: F401
)
from tests.test_torch_train import _batch, _grad_tol, _leaves
from tests.test_torch_upconv import _stage as _up_stage
from tests.test_torch_upconv import _torch_params

FUSED = dict(stem_stages=5, upconv_stages=4)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return _err(got, want) / max(1.0, float(np.max(np.abs(want))))


def test_every_width_is_built():
    """No width of the two models is left without a kernel body."""
    for dtype in (torch.float32, torch.bfloat16):
        assert set(ENCODER_FILTERS) <= set(STEM_CHANNELS[dtype])
    assert set(ENCODER_FILTERS) <= set(STEM_MAX_CI_BF16)
    assert set(DECODER_FILTERS) <= set(UPCONV_CHANNELS)
    assert set(DECODER_FILTERS) <= set(UPCONV_MAX_CI_BF16)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("fn", [downconv_stage_plain, downconv_stage_cuda])
@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 256)])
def test_wide_downconv_stage_matches_pallas(fn, cin, cout):
    """Encoder stages 3 and 4 on an 8 x 16 input, float32."""
    _, v, x, params = _down_stage(8, 16, cin, cout, seed=cin)
    want = downconv_stage_pallas(jnp.asarray(x), v["params"],
                                 dtype=jnp.float32, tile_rows=4,
                                 interpret=True)
    got = fn(torch.from_numpy(x), params, torch.float32)
    assert got.shape == want.shape == (2, 4, 8, cout)
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("fn", [upconv_stage_plain, upconv_stage_cuda])
@pytest.mark.parametrize("cout", [128, 64])
def test_wide_upconv_stage_matches_pallas(fn, cout):
    """Decoder stages 0 and 1 (Ci 256) on a 4 x 8 input, float32."""
    p, x = _up_stage(4, 8, 256, cout, seed=cout)
    want = upconv_stage_pallas(jnp.asarray(x), p, dtype=jnp.float32,
                               tile_rows=4, interpret=True)
    wt, b = _torch_params(p)
    got = fn(torch.from_numpy(x), wt, b, torch.float32)
    assert got.shape == want.shape == (2, 8, 16, cout)
    assert _rel_err(got, want) <= 1e-5


# ---------------------------------------------------------------- (b)

def test_wide_downconv_trainable_gradients_match_jax():
    """Encoder stage 3 (64 -> 128): d_x and every parameter's gradient
    through the trainable Function against JAX's custom VJP."""
    _, v, x, params = _down_stage(8, 16, 64, 128, seed=3)

    def loss_j(p, x):
        return jnp.sum(jnp.sin(j_downconv_stage_trainable(
            x, p, dtype=jnp.float32, tile_rows=4, interpret=True)))

    gp, gx = jax.grad(loss_j, (0, 1))(v["params"], jnp.asarray(x))
    leaves = [torch.from_numpy(x).requires_grad_()]
    for w, b in params:
        leaves += [w.clone().requires_grad_(), b.clone().requires_grad_()]
    y = downconv_stage_trainable(
        leaves[0], [(leaves[i], leaves[i + 1]) for i in (1, 3, 5)],
        torch.float32)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(gx),
                               atol=1e-5)
    for k, name in enumerate(("conv_a", "conv_aa", "conv_b")):
        gw = leaves[1 + 2 * k].grad.numpy().transpose(2, 3, 1, 0)
        np.testing.assert_allclose(gw, np.asarray(gp[name]["kernel"]),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(leaves[2 + 2 * k].grad.numpy(),
                                   np.asarray(gp[name]["bias"]), atol=1e-4,
                                   rtol=1e-5)


def test_wide_upconv_trainable_gradients_match_jax():
    """Decoder stage 1 (256 -> 64), as tests/test_torch_upconv.py holds
    the narrow stages."""
    p, x = _up_stage(4, 8, 256, 64, seed=5)

    def loss_j(p, x):
        return jnp.sum(jnp.sin(j_upconv_stage_trainable(
            x, p, dtype=jnp.float32, tile_rows=4, interpret=True)))

    gp, gx = jax.grad(loss_j, (0, 1))(p, jnp.asarray(x))
    wt, b = _torch_params(p)
    leaves = [t.clone().requires_grad_() for t in
              (torch.from_numpy(x), wt, b)]
    y = upconv_stage_trainable(leaves[0], [tuple(leaves[1:])],
                               torch.float32)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(gx),
                               atol=1e-5)
    gw = np.flip(leaves[1].grad.numpy().transpose(2, 3, 0, 1), (0, 1))
    np.testing.assert_allclose(gw, np.asarray(gp["conv_up"]["kernel"]),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(leaves[2].grad.numpy(),
                               np.asarray(gp["conv_up"]["bias"]), atol=1e-4,
                               rtol=1e-5)


# ---------------------------------------------------------------- (c), (d)

class _Counting:
    """Record the input width of every call of the K2 and K5 wrappers
    (the Functions look them up at call time)."""

    def __init__(self):
        self.calls = {"stem": [], "up": []}
        self._saved = []

    def __enter__(self):
        for module, name, key in ((stem_kernel, "downconv_stage_cuda",
                                   "stem"),
                                  (upconv_kernel, "upconv_stage_cuda", "up")):
            orig = getattr(module, name)

            def counting(*a, _orig=orig, _key=key, **k):
                self.calls[_key].append(a[0].shape[-1])
                return _orig(*a, **k)

            self._saved.append((module, name, orig))
            setattr(module, name, counting)
        return self

    def __exit__(self, *exc):
        for module, name, orig in self._saved:
            setattr(module, name, orig)


def test_fully_fused_flow_net_matches_jax(flow_setup):
    model_j, variables = flow_setup
    v = _seeded(variables, "diag", seed=6, hw=TEST_HW)
    x = _inputs(7, hw=TEST_HW)
    want = np.asarray(model_j.clone(**FUSED).apply(v, jnp.asarray(x),
                                                   train=False))
    port = load_flax_variables(build_flow_net(0, "cpu", **FUSED), v)
    with _Counting() as c, torch.no_grad():
        got = port(torch.from_numpy(x))
    # the encoder on the stacked pair once (fuse_batch): every stage's
    # input width, and every decoder stage's
    assert c.calls["stem"] == [3, *ENCODER_FILTERS[:-1]]
    assert c.calls["up"] == [256, 256, 128, 64]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.mean(np.abs(want))) > 0.1
    assert _err(got, want) <= 1e-4 * max(1.0, float(np.max(np.abs(want))))


def test_fully_fused_interpolator_matches_jax(interp_setup):
    """The eval forward's image and both directions' flows."""
    model_j, variables = interp_setup
    v = _seeded(variables, "diag", seed=8, hw=TEST_HW)
    x = _inputs(9, hw=TEST_HW)
    want, (w01, w10) = model_j.clone(**FUSED).apply(
        v, jnp.asarray(x), train=False, return_flows=True)
    port = load_flax_variables(build_interpolator(0, "cpu", **FUSED), v)
    with _Counting() as c, torch.no_grad():
        got, (g01, g10) = port(torch.from_numpy(x), return_flows=True)
    assert len(c.calls["stem"]) == 5 and len(c.calls["up"]) == 4
    assert got.shape == want.shape
    assert _err(got, want) <= 1e-4 * max(1.0, float(np.max(np.abs(want))))
    assert float(np.mean(np.abs(np.asarray(w01[-1])))) > 0.1
    for a, b in zip(g01 + g10, list(w01) + list(w10)):
        assert a.shape == b.shape
        assert _err(a, b) <= 1e-4 * max(1.0, float(np.max(np.abs(b))))


# ---------------------------------------------------------------- (e)

def test_fully_fused_train_step_matches_plain_model(flow_setup):
    """One flow train step (plain chain) of the fully fused model against
    the model without fused stages, from the same parameters and batch:
    the loss and every gradient (K2 and K5 through their trainable
    Functions: the plain composition's backward, recomputed)."""
    _, variables = flow_setup
    v = _seeded(variables, "diag", seed=10, k=0.5, hw=TEST_HW)
    ims, flo = _batch(11)
    batch = {"ims": torch.from_numpy(ims), "flo": torch.from_numpy(flo)}
    out = {}
    for name, kw in (("fused", FUSED),
                     ("plain", dict(stem_stages=0, upconv_stages=0))):
        model = load_flax_variables(build_flow_net(0, "cpu", **kw), v)
        with _Counting() as c:
            m = make_flow_train_step()(model, plain_optimizer(model, 0.0),
                                       batch)
        assert len(c.calls["stem"]) == (5 if name == "fused" else 0)
        assert len(c.calls["up"]) == (4 if name == "fused" else 0)
        out[name] = (float(m["loss"]),
                     _leaves(to_flax_tree(model, "grads")))
    (loss, got), (loss_p, want) = out["fused"], out["plain"]
    assert np.isfinite(loss)
    assert abs(loss - loss_p) <= 1e-5 * max(1.0, abs(loss_p))
    assert got.keys() == want.keys()
    for k in want:
        err = float(np.max(np.abs(got[k] - want[k])))
        assert err <= _grad_tol(k, want) or err == 0.0, (k, err)
