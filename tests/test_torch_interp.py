"""The port's frame-interpolation slice against the JAX package on CPU:
FrameInterpolate, PWCInterpolator (eval and train mode, fuse_batch True
and False), the pretraining losses and one make_interp_train_step step,
transfer_params, the triplet data path (synthetic triplets,
preprocessing, the augmentation with the same draws), and the two apps.

One Flax tree is loaded into both models. Fresh 'diag' flow heads output
zero flows, which make the warps trivial, so the model tests draw the
flow heads, BatchNorm state and conv biases from a numpy seed first
(tests/test_torch_model._seeded). Tolerances are stated at each check;
the gradient and parameter checks are tests/test_torch_train.py's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qpwcnet_torch.apps import interp_infer, pretrain_interp
from qpwcnet_torch.data import (
    apply_triplet_augmentation,
    preprocess_triplet_batch,
    rotation_matrix_from_euler,
    synthetic_triplet_batch,
)
from qpwcnet_torch.data.synthetic import triplet_frames
from qpwcnet_torch.layout import nchw, nhwc
from qpwcnet_torch.models import (
    FrameInterpolate,
    build_flow_net,
    build_interpolator,
    load_flax_variables,
)
from qpwcnet_torch.models.from_flax import to_flax_tree
from qpwcnet_torch.train import (
    auto_resize_mse_loss,
    default_optimizer,
    make_interp_train_step,
    multiscale_interp_loss,
    plain_optimizer,
    transfer_params,
)
from qpwcnet_tpu.data.augment import augment_triplet_batch as j_augment
from qpwcnet_tpu.data.augment import (
    rotation_matrix_from_euler as j_rotation,
)
from qpwcnet_tpu.data.pipeline import (
    preprocess_triplet_batch as j_preprocess,
)
from qpwcnet_tpu.models.blocks import FrameInterpolate as JFrameInterpolate
from qpwcnet_tpu.models.pwcnet import PWCInterpolator as JPWCInterpolator
from qpwcnet_tpu.ops.warp import backward_warp as j_warp
from qpwcnet_tpu.train import create_interp_train_state
from qpwcnet_tpu.train import make_interp_train_step as j_make_step
from qpwcnet_tpu.train.agc import zero_nan_grads as j_zero_nan_grads
from qpwcnet_tpu.train.checkpoint import transfer_params as j_transfer
from qpwcnet_tpu.train.losses import (
    auto_resize_mse_loss as j_auto_resize_mse_loss,
)
from qpwcnet_tpu.train.losses import (
    multiscale_interp_loss as j_multiscale_interp_loss,
)
from qpwcnet_tpu.train.train_state import default_optimizer as j_default_opt
from tests.conftest import TEST_HW
from tests.test_models import _expected_interp_params
from tests.test_torch_model import (
    _seeded,
    one_torch_thread,  # noqa: F401
)
from tests.test_torch_train import (
    LR,
    _check_params,
    _grad_tol,
    _leaves,
    _np_tree,
    _recording,
)

H, W = TEST_HW


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _inputs(seed, b=2):
    return np.random.RandomState(seed).uniform(
        -0.5, 0.5, (b, H, W, 6)).astype(np.float32)


def _port(v, **kw):
    return load_flax_variables(build_interpolator(0, "cpu", **kw), v)


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("up", [False, True])
def test_frame_interpolate_matches_jax(up):
    """Flows of a few px, so both warps sample between pixels."""
    rng = np.random.RandomState(int(up))
    c = 8 if up else 3
    prv, nxt = (rng.randn(2, 8, 16, c).astype(np.float32) for _ in range(2))
    flo_01, flo_10 = (rng.uniform(-3, 3, (2, 8, 16, 2)).astype(np.float32)
                      for _ in range(2))
    img_u = rng.randn(2, 8, 16, 3).astype(np.float32) if up else None
    m = JFrameInterpolate(up=up)
    args = [jnp.asarray(a) for a in (prv, nxt, flo_01, flo_10)]
    if up:
        args.append(jnp.asarray(img_u))
    v = m.init(jax.random.key(2), *args)
    want = np.asarray(m.apply(v, *args))
    port = load_flax_variables(FrameInterpolate(c, up=up), _np_tree(v))
    t = [nchw(torch.from_numpy(a)) for a in (prv, nxt, flo_01, flo_10)]
    if up:
        t.append(nchw(torch.from_numpy(img_u)))
    with torch.no_grad():
        got = nhwc(port(*t))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _err(got, want) <= 1e-5 * max(1.0, float(np.max(np.abs(want))))


def test_interpolator_param_count_and_tree(interp_setup):
    _, variables = interp_setup
    model = build_interpolator(0, "cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        _expected_interp_params()
    v = _np_tree(variables)
    port = _port(v)
    assert len(port.state_dict()) == len(jax.tree_util.tree_leaves(v))
    back = to_flax_tree(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v["params"])
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v["params"])):
        np.testing.assert_array_equal(a, b)


def test_interpolator_eval_matches_jax(interp_setup):
    """Final image within 1e-5 and the flows of both directions within
    1e-4 of their magnitude (test_models.py's bounds for the JAX model's
    own fused and unfused passes)."""
    model_j, variables = interp_setup
    v = _seeded(variables, "diag", seed=3, hw=TEST_HW)
    x = _inputs(4)
    want, (w01, w10) = jax.jit(functools.partial(
        model_j.apply, train=False, return_flows=True))(v, jnp.asarray(x))
    with torch.no_grad():
        got, (g01, g10) = _port(v)(torch.from_numpy(x), return_flows=True)
    assert got.shape == want.shape == (2, H, W, 3)
    assert _err(got, want) <= 1e-5
    fin = np.asarray(w01[-2])
    assert 0.5 < float(np.mean(np.abs(fin))) < 5.0
    assert len(g01) == len(g10) == 6
    for a, b in zip(g01 + g10, list(w01) + list(w10)):
        assert a.shape == b.shape
        assert _err(a, b) <= 1e-4 * max(1.0, float(np.max(np.abs(b))))


@pytest.mark.parametrize("fuse_batch", [True, False])
def test_interpolator_train_mode_matches_jax(interp_setup, fuse_batch):
    """All 6 images in train mode and the updated BatchNorm statistics,
    with the direction-fused Flower (joint 2B statistics) and without it
    (two passes, the statistics updated twice), each against the JAX
    model in the same mode. Images within 1e-5 of their magnitude,
    statistics within 1e-5."""
    _, variables = interp_setup
    v = _seeded(variables, "diag", seed=5, k=0.5, hw=TEST_HW)
    x = _inputs(6)
    model_j = JPWCInterpolator(cv_impl="xla", fuse_batch=fuse_batch)
    outs_j, upd = jax.jit(functools.partial(
        model_j.apply, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
    model = _port(v, fuse_batch=fuse_batch).train()
    with torch.no_grad():
        outs = model(torch.from_numpy(x), multiscale=True)
    assert len(outs) == len(outs_j) == 6
    for i, (a, b) in enumerate(zip(outs, outs_j)):
        s = 32 >> i if i < 5 else 1
        assert a.shape == b.shape == (2, H // s, W // s, 3)
        assert _err(a, b) <= 1e-5 * max(1.0, float(np.max(np.abs(b)))), i
    got = to_flax_tree(model, "params")  # structure only
    assert "img_4" in got
    stats = _leaves(upd["batch_stats"])
    mods = dict(model.named_modules())
    for key, want in stats.items():
        # "['flower']['upflow_0']['flow']['norm']['mean']"
        parts = [p.strip("[]'") for p in key.split("][")]
        name = ".".join(parts[:-1]).replace("upflow_", "upflows.")
        buf = mods[name].running_mean if parts[-1] == "mean" else \
            mods[name].running_var
        assert _err(buf, want) <= 1e-5, key


# --------------------------------------------------------------- losses

def test_interp_losses_match_jax():
    rng = np.random.RandomState(7)
    true = rng.uniform(-0.5, 0.5, (2, 32, 64, 3)).astype(np.float32)
    preds = [rng.uniform(-0.5, 0.5, (2, 32 >> i, 64 >> i, 3))
             .astype(np.float32) for i in (5, 4, 3, 2, 1, 0)]
    t = torch.from_numpy(true)
    for p in preds:
        a = auto_resize_mse_loss(t, torch.from_numpy(p))
        b = j_auto_resize_mse_loss(jnp.asarray(true), jnp.asarray(p))
        assert abs(float(a) - float(b)) <= 1e-6
    total, per = multiscale_interp_loss(t, [torch.from_numpy(p)
                                           for p in preds])
    total_j, per_j = j_multiscale_interp_loss(
        jnp.asarray(true), [jnp.asarray(p) for p in preds])
    assert per.keys() == per_j.keys() == {f"img_{i}_loss" for i in range(6)}
    assert abs(float(total) - float(total_j)) <= 1e-6
    for k in per:
        assert abs(float(per[k]) - float(per_j[k])) <= 1e-6


# ----------------------------------------------------------- train step

def test_interp_train_step_matches_jax(interp_setup):
    """One pretraining step from the same parameters and batch: the loss
    and per-scale losses, every gradient, the BatchNorm statistics, and
    the parameters after the plain and the reference chains."""
    model_j, variables = interp_setup
    v = _seeded(variables, "diag", seed=8, k=0.5, hw=TEST_HW)
    rng = np.random.RandomState(9)
    ims = rng.uniform(-0.5, 0.5, (2, H, W, 6)).astype(np.float32)
    mid = rng.uniform(-0.5, 0.5, (2, H, W, 3)).astype(np.float32)

    tx = optax.chain(_recording(), j_zero_nan_grads(), optax.adam(LR))
    state = create_interp_train_state(model_j, v, tx=tx)
    new, metrics = jax.jit(j_make_step())(
        state, {"ims": jnp.asarray(ims), "mid": jnp.asarray(mid)})
    grads_j = _np_tree(new.opt_state[0])
    ref = j_default_opt(LR)
    upd, _ = jax.jit(ref.update)(new.opt_state[0],
                                 ref.init(v["params"]), v["params"])
    ref_j = _np_tree(optax.apply_updates(v["params"], upd))
    batch = {"ims": torch.from_numpy(ims), "mid": torch.from_numpy(mid)}

    for chain, want_params in ((plain_optimizer, _np_tree(new.params)),
                               (default_optimizer, ref_j)):
        model = _port(v)
        m = make_interp_train_step()(model, chain(model, LR), batch)
        assert set(m) == set(metrics)
        for k in m:
            # float32 losses summed in another order
            assert abs(float(m[k]) - float(metrics[k])) <= \
                1e-5 * max(1.0, abs(float(metrics[k]))), k
        if chain is plain_optimizer:
            got, want = _leaves(to_flax_tree(model, "grads")), \
                _leaves(grads_j)
            assert got.keys() == want.keys()
            for k in want:
                err = float(np.max(np.abs(got[k] - want[k])))
                assert err <= _grad_tol(k, want) or err == 0.0, (k, err)
            for k, w in _leaves(new.batch_stats).items():
                parts = [p.strip("[]'") for p in k.split("][")]
                name = ".".join(parts[:-1]).replace("upflow_", "upflows.")
                mod = dict(model.named_modules())[name]
                buf = mod.running_mean if parts[-1] == "mean" else \
                    mod.running_var
                assert _err(buf, w) <= 1e-5, k
        _check_params(to_flax_tree(model), want_params, grads_j)


def test_transfer_params_matches_jax(flow_setup, interp_setup):
    _, v_flow = flow_setup
    _, v_interp = interp_setup
    src = _port(_np_tree(v_interp))
    dst = load_flax_variables(build_flow_net(0, "cpu"), _np_tree(v_flow))
    stats = {k: b.clone() for k, b in dst.named_buffers()}
    out = transfer_params(src, dst)
    assert out is dst
    want = _leaves(j_transfer(_np_tree(v_interp["params"]),
                              _np_tree(v_flow["params"])))
    got = _leaves(to_flax_tree(dst))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # BatchNorm statistics stay the destination's, as JAX's params-only
    # transfer leaves them
    for k, b in dst.named_buffers():
        assert torch.equal(b, stats[k])


def test_transfer_params_refuses_mismatch():
    src = build_interpolator(0, "cpu")
    with pytest.raises(KeyError):
        transfer_params(src, build_flow_net(0, "cpu"),
                        subtrees=("encoder", "imgs"))
    dst = build_flow_net(0, "cpu")
    before = dst.encoder.stages[0].conv_a.weight.clone()
    src.decoder.stages[0].conv_up.weight = torch.nn.Parameter(
        torch.zeros(256, 64, 4, 4))
    with pytest.raises(ValueError):
        transfer_params(src, dst)
    assert torch.equal(dst.encoder.stages[0].conv_a.weight, before)


# ----------------------------------------------------------------- data

def test_triplet_frames_match_jax():
    """The deterministic part of synthetic_triplet_batch (given the
    padded texture and flow) against the JAX function's body: the warps
    agree to float32 rounding, so the uint8 frames to one level."""
    rng = np.random.RandomState(10)
    pad = 4
    tex = rng.uniform(0, 1, (2, 20 + 2 * pad, 24 + 2 * pad, 3)).astype(
        np.float32)
    flo = rng.uniform(-3, 3, tex.shape[:3] + (2,)).astype(np.float32)
    got = triplet_frames(torch.from_numpy(tex), torch.from_numpy(flo), 20,
                         24, pad)
    sl = (slice(None), slice(pad, pad + 20), slice(pad, pad + 24))
    jt, jf = jnp.asarray(tex), jnp.asarray(flo)
    for g, f in zip(got, (j_warp(jt, jf), j_warp(jt, jf * 0.5), jt)):
        want = np.clip(np.round(np.asarray(f)[sl] * 255.0), 0, 255)
        assert g.dtype == torch.uint8 and g.shape == (2, 20, 24, 3)
        assert np.max(np.abs(g.numpy().astype(np.float32) - want)) <= 1.0


def test_synthetic_triplet_batch():
    a, b, c = synthetic_triplet_batch(torch.Generator().manual_seed(3), 2,
                                      24, 40, max_disp=6.0)
    again = synthetic_triplet_batch(torch.Generator().manual_seed(3), 2, 24,
                                    40, max_disp=6.0)
    for t, u in zip((a, b, c), again):
        assert t.shape == (2, 24, 40, 3) and t.dtype == torch.uint8
        assert torch.equal(t, u)
    assert not torch.equal(a, c) and not torch.equal(a, b)


def test_preprocess_triplet_batch_matches_jax():
    rng = np.random.RandomState(11)
    frames = [rng.randint(0, 256, (2, 16, 24, 3)).astype(np.uint8)
              for _ in range(3)]
    want = j_preprocess(jax.random.key(0), *map(jnp.asarray, frames),
                        augment=False)
    got = preprocess_triplet_batch(None, *map(torch.from_numpy, frames),
                                   augment=False)
    for k in ("ims", "mid"):
        assert got[k].shape == want[k].shape
        assert _err(got[k], want[k]) <= 1e-6


def test_rotation_matrix_matches_jax():
    angles = np.random.RandomState(12).uniform(-1, 1, (4, 3)).astype(
        np.float32)
    got = rotation_matrix_from_euler(torch.from_numpy(angles))
    assert _err(got, j_rotation(jnp.asarray(angles))) <= 1e-6
    eye = got @ got.transpose(-1, -2)
    assert _err(eye, np.broadcast_to(np.eye(3), (4, 3, 3))) <= 1e-5


def test_triplet_augmentation_matches_jax():
    """The JAX function's draws, remade from its key with the same splits,
    fed to the port's deterministic part: the photometric transform, the
    noise and the flips agree to float32 rounding."""
    rng = np.random.RandomState(13)
    a, b, c = (rng.uniform(0, 1, (4, 8, 12, 3)).astype(np.float32)
               for _ in range(3))
    key = jax.random.key(5)
    want = j_augment(key, *map(jnp.asarray, (a, b, c)))
    kp, kn, kud, klr = jax.random.split(key, 4)
    kt, kr, ks = jax.random.split(kp, 3)
    z = (1, 4, 1, 1, 3)
    draws = {
        "txn": jax.random.uniform(kt, z, minval=-0.3, maxval=0.3),
        "rxn": jax.random.uniform(kr, z, minval=-0.3, maxval=0.3),
        "scale": jnp.exp(jax.random.uniform(ks, z, minval=-0.3,
                                            maxval=0.3)),
        "noise": jax.random.normal(kn, (1, 4, 8, 12, 3)),
        "flip_ud": jax.random.uniform(kud, (1, 4, 1, 1, 1)) < 0.5,
        "flip_lr": jax.random.uniform(klr, (1, 4, 1, 1, 1)) < 0.5,
    }
    flips = [np.asarray(draws[k]).ravel() for k in ("flip_ud", "flip_lr")]
    assert all(f.any() and not f.all() for f in flips)
    got = apply_triplet_augmentation(
        *map(torch.from_numpy, (a, b, c)),
        {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _err(g, w) <= 1e-5


def test_triplet_augmentation_draws_on_the_generator():
    frames = [torch.rand(2, 8, 12, 3, generator=torch.Generator()
                         .manual_seed(i)) for i in range(3)]
    one = preprocess_triplet_batch(torch.Generator().manual_seed(1),
                                   *frames)
    two = preprocess_triplet_batch(torch.Generator().manual_seed(1),
                                   *frames)
    other = preprocess_triplet_batch(torch.Generator().manual_seed(2),
                                     *frames)
    assert torch.equal(one["ims"], two["ims"])
    assert not torch.equal(one["ims"], other["ims"])


# ----------------------------------------------------------------- apps

APP_ARGS = ["--batch-size", "2", "--height", "32", "--width", "64",
            "--device", "cpu", "--log-every", "1", "--recalibrate-final",
            "2", "--ckpt-every", "100"]


def test_pretrain_app_runs_on_cpu(capsys, tmp_path):
    metrics = pretrain_interp.main(APP_ARGS + ["--steps", "2", "--run-root",
                                               str(tmp_path)])
    assert set(metrics) == {"loss", "mse_eval",
                            *(f"img_{i}_loss" for i in range(6))}
    assert all(np.isfinite(v) for v in metrics.values())
    err = capsys.readouterr().err
    assert "step 2: loss=" in err and "mse_eval=" in err
    assert "recalibrated BN stats" in err
    assert f"run dir: {tmp_path / '000'}" in err


@pytest.mark.parametrize("extra", [["--debug-nan", "true"]])
def test_pretrain_app_refuses_unported_modes(tmp_path, extra):
    """--debug-nan, once refused, is accepted: the run finishes with
    finite losses (tests/test_torch_profiling.py holds its losses to the
    run without it and its FloatingPointError at a NaN)."""
    metrics = pretrain_interp.main(APP_ARGS + ["--steps", "2", "--run-root",
                                               str(tmp_path)] + extra)
    assert all(np.isfinite(v) for v in metrics.values())
    assert (tmp_path / "000" / "ckpt").is_dir()


@pytest.mark.parametrize("data", ["synthetic", "dummy"])
def test_interp_infer_app_runs_on_cpu(tmp_path, data):
    results = interp_infer.main(["--data", data, "--n", "1", "--height",
                                 "32", "--width", "64", "--device", "cpu",
                                 "--out-dir", str(tmp_path)])
    assert len(results) == 1 and np.isfinite(results[0]["halfwarp_l1"])
    assert len(list(tmp_path.glob("*.png"))) == 7
    if data == "synthetic":
        assert np.isfinite(results[0]["psnr"])


def test_profiling_categories():
    """The profiler breakdown's kernel-name categories and busy-time
    union (the breakdown itself needs the card)."""
    from qpwcnet_torch.utils.profiling import _union_us, category

    names = {
        "void qpw::correlate_kernel<__nv_bfloat16, false>(int)": "K1",
        "void qpw::correlate_kernel<float, true>(int)": "K3",
        "void qpw::cv_bwd_kernel<__nv_bfloat16, false>(int)": "K4a",
        "void qpw::cv_bwd_kernel<float, true>(int)": "K4b",
        "void qpw::stem_kernel<float, 16>(int)": "K2",
        "void qpw::upconv_kernel<32>(int)": "K5",
        "void qpw::upconv_mma_kernel<32, 4>(int)": "K5",
        "sm90_xmma_fprop_implicit_gemm_bf16": "cuDNN",
        "void at::native::vectorized_elementwise_kernel<4>": "elementwise",
        "void at::native::reduce_kernel<512, 1>": "reduce",
        "void at::native::index_elementwise_kernel<128>": "gather/scatter",
        "void at::native::CatArrayBatchedCopy<int>": "concat",
        "void at::native::multi_tensor_apply_kernel<Adam>": "optimizer",
        "Memcpy DtoD": "other",
    }
    for name, cat in names.items():
        assert category(name) == cat, name
    assert _union_us([(0, 2), (1, 3), (5, 6)]) == 4.0
