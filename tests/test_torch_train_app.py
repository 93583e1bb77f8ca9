"""The PyTorch port's flow training on CPU beyond one step: the loss
falling over steps in bf16, the synthetic data and its preprocessing
(against the JAX package's), and the train app (split from
tests/test_torch_train.py so that the two files run on different test
workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_tpu.data.pipeline import preprocess_flow_batch as j_preprocess
from qpwcnet_torch.apps import train_flow
from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch
from qpwcnet_torch.models import build_flow_net
from qpwcnet_torch.ops.warp import backward_warp
from qpwcnet_torch.train import default_optimizer, make_flow_train_step
from tests.conftest import TEST_HW
from tests.test_torch_model import one_torch_thread  # noqa: F401

H, W = TEST_HW


def test_train_loss_decreases_bf16():
    """bf16 compute, float32 parameters: the loss falls over 8 steps on a
    fixed batch and stays finite (test_train.py's JAX check)."""
    model = build_flow_net(0, "cpu", dtype=torch.bfloat16)
    opt = default_optimizer(model, 3e-4)
    step = make_flow_train_step()
    rng = np.random.RandomState(0)
    batch = {"ims": torch.from_numpy(rng.uniform(
        -0.5, 0.5, (2, H, W, 6)).astype(np.float32)),
        "flo": torch.tensor([2.0, -1.0]).expand(2, H, W, 2).contiguous()}
    first = float(step(model, opt, batch)["loss"])
    for _ in range(8):
        last = float(step(model, opt, batch)["loss"])
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first, (first, last)
    assert {p.dtype for p in model.parameters()} == {torch.float32}


# ---------------------------------------------------------------- data

def test_synthetic_flow_batch():
    gen = torch.Generator().manual_seed(3)
    ims, flo = synthetic_flow_batch(gen, 2, 40, 56, max_disp=6.0)
    assert ims.shape == (2, 40, 56, 6) and ims.dtype == torch.uint8
    assert flo.shape == (2, 40, 56, 2) and flo.dtype == torch.float32
    assert float(flo.abs().max()) <= 6.0
    assert float(flo.abs().mean()) > 0.5
    again = synthetic_flow_batch(torch.Generator().manual_seed(3), 2, 40, 56,
                                 max_disp=6.0)
    assert torch.equal(ims, again[0]) and torch.equal(flo, again[1])
    other = synthetic_flow_batch(torch.Generator().manual_seed(4), 2, 40, 56,
                                 max_disp=6.0)
    assert not torch.equal(ims, other[0])
    # prv = warp(nxt, flo) wherever the sample lies inside the cropped
    # nxt: both frames are rounded to uint8, so within 1/255
    prv, nxt = ims[..., :3].float() / 255, ims[..., 3:].float() / 255
    gy, gx = torch.meshgrid(torch.arange(40.0), torch.arange(56.0),
                            indexing="ij")
    qx, qy = gx + flo[..., 0], gy + flo[..., 1]
    inside = (qx >= 0) & (qx <= 55) & (qy >= 0) & (qy <= 39)
    assert float(inside.float().mean()) > 0.5
    err = (prv - backward_warp(nxt, flo)).abs().amax(-1)
    assert float(err[inside].max()) <= 1.0 / 255 + 1e-6


@pytest.mark.parametrize("out_hw", [(16, 32), (24, 40)])
def test_preprocess_flow_batch_matches_jax(out_hw):
    """A resize (flow rescaled per axis), and the app's same-size call
    with a NaN in the flow, which the scrub zeroes. (A NaN under a
    downsampling resize spreads over each package's own filter support,
    which differ.)"""
    rng = np.random.RandomState(6)
    ims = rng.randint(0, 256, (2, 24, 40, 6)).astype(np.uint8)
    flo = rng.uniform(-5, 5, (2, 24, 40, 2)).astype(np.float32)
    if out_hw == (24, 40):
        flo[0, 3, 4, 1] = np.nan
    want = j_preprocess(jax.random.key(0), jnp.asarray(ims),
                        jnp.asarray(flo), out_hw=out_hw, augment=False)
    got = preprocess_flow_batch(torch.from_numpy(ims), torch.from_numpy(flo),
                                out_hw=out_hw)
    for k in ("ims", "flo"):
        assert got[k].shape == want[k].shape
        # bilinear resize of float32 values: rounding-level
        err = float(np.max(np.abs(got[k].numpy() - np.asarray(want[k]))))
        assert err <= 1e-5 * max(1.0, float(np.max(np.abs(want[k])))), k
    assert bool(torch.isfinite(got["flo"]).all())


# ----------------------------------------------------------------- app

APP_ARGS = ["--data", "synthetic", "--curriculum", "1", "--batch-size", "2",
            "--height", "32", "--width", "64", "--device", "cpu",
            "--log-every", "1", "--recalibrate-final", "2",
            "--ckpt-every", "100"]


def test_train_app_runs_on_cpu(capsys, tmp_path):
    metrics = train_flow.main(APP_ARGS + ["--steps", "2", "--run-root",
                                          str(tmp_path)])
    assert set(metrics) == {"loss", "epe"}
    assert all(np.isfinite(v) for v in metrics.values())
    err = capsys.readouterr().err
    assert "skip 1/4 stage" in err and "step 2: loss=" in err
    assert "epe_eval=" in err and "recalibrated BN stats" in err
    assert f"run dir: {tmp_path / '000'}" in err
