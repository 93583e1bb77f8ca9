"""The port's models on a CUDA card at the benchmark's shapes: each path
with the kernels against the plain models, with each kernel's launches.

  * the flow net at 448x1024 b8 (exact, 'fast', plain; bf16 and float32),
    its CUDA-graph replays, the card against the CPU, the infer app;
  * the flow train step at 256x512 b16: every gradient against the plain
    model's, the plain bf16 step repeated bit for bit, the loss falling,
    the train app;
  * the interpolator at 256x512 b8 (stem_stages=2, upconv_stages=2): the
    eval forward, every pretraining-step gradient, the loss falling, the
    library entry points, the pretrain_interp and interp_infer apps;
  * the fully fused configuration (stem_stages=5, upconv_stages=4) on the
    three paths;
  * the H-sharded path on the local transport against the unsharded
    model.

A test that runs a main path (an app, or the library's entry points as a
user calls them) holds the path's exact launches of every K1-K5 mode
(``counts_of``), which together launch each kernel, and its bias + Mish
launches (``main_path``). The plain models run no hand-written kernel:
their convs' epilogue runs the composition (``plain_epilogue``). Tests
that compare gradients run with cuDNN's deterministic algorithms.

Every test is marked ``cuda`` and skips without a card; the file imports
neither jax nor the JAX package (run as tests/test_torch_cuda.py says).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from qpwcnet_torch.ops import cuda as kernels
from test_torch_cuda import (
    B,
    H,
    SPATIAL_N_FWD,
    SPATIAL_N_TRAIN,
    TRAIN_B,
    TRAIN_H,
    TRAIN_W,
    W,
)

SEED = 0
# Flow-head scale of the train steps: train-mode BatchNorm normalizes the
# head features up, so flows of ~1 px take a smaller k than eval mode's.
TRAIN_K = 0.2
# bf16 gradients of the kernel models against the plain model's, as a
# multiple of the plain model's own bf16-against-float32 error
BF16_GRAD_FACTOR = 2.0
# The flow net's kernel models and its plain model
MODES = {"exact": dict(cv_impl="auto", stem_stages=2),
         "fast": dict(cv_impl="fast", stem_stages=2),
         "plain": dict(cv_impl="plain", stem_stages=0)}
# The interpolator: the JAX bench's pretraining configuration at batch 8,
# the kernel model's options and the plain model's
INTERP_B = 8
INTERP_KW = dict(cv_impl="auto", stem_stages=2, upconv_stages=2)
PLAIN_KW = dict(cv_impl="plain", stem_stages=0, upconv_stages=0)
# Every encoder stage through K2, every decoder stage through K5
FUSED_KW = dict(stem_stages=5, upconv_stages=4)
# The H-sharded paths' warp halos: the forward in 2 shards, the train
# step in 4 (tests/test_spatial.py's)
SPATIAL_HALO_FWD, SPATIAL_HALO_TRAIN = 16, 8
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module")
def dev():
    """The first CUDA device, with TF32 off so float32 convs are full
    float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def x(dev):
    """The headline batch: 8 pairs at 448x1024."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    return torch.rand((B, H, W, 6), generator=g, device=dev) - 0.5


@pytest.fixture(scope="module")
def batch(dev):
    """A synthetic flow training batch at 256x512 b16."""
    from qpwcnet_torch.data import preprocess_flow_batch, synthetic_flow_batch

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    ims_u8, flo = synthetic_flow_batch(gen, TRAIN_B, TRAIN_H, TRAIN_W)
    return preprocess_flow_batch(ims_u8, flo, out_hw=(TRAIN_H, TRAIN_W))


@pytest.fixture(scope="module")
def ibatch(dev):
    """A synthetic pretraining triplet batch at 256x512 b8."""
    return interp_batch(dev, SEED + 8)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, restored after: the gradient and
    resume checks need them, since cuDNN's weight gradients of the flow
    heads' 2-channel output convs otherwise change between runs."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@pytest.fixture
def deterministic():
    with cudnn_deterministic():
        yield


# ---------------------------------------------------------------- helpers

def interp_batch(dev, seed, augment=False):
    from qpwcnet_torch.data import (
        preprocess_triplet_batch, synthetic_triplet_batch)

    gen = torch.Generator(device=dev).manual_seed(seed)
    a, b, c = synthetic_triplet_batch(gen, INTERP_B, TRAIN_H, TRAIN_W)
    return preprocess_triplet_batch(gen, a, b, c, augment=augment)


def seed_flow_heads(model, seed: int, hw, k: float = 1.5) -> None:
    """Non-zero flow heads: of_flow ~ N(0, (k / s)^2), s = sqrt(h² + w²)
    of the level (the 'diag' output scale), and BatchNorm scale, bias and
    running statistics from a seed. k = 1.5 gives eval-mode flows of a few
    px with some beyond ±4 at the finest level (fresh 'diag' heads output
    exactly 0)."""
    rng = np.random.RandomState(seed)
    heads = [model.flower.flow_0.flow] + [u.flow
                                          for u in model.flower.upflows]
    with torch.no_grad():
        for i, head in enumerate(heads):
            h, w = hw[0] >> (5 - i), hw[1] >> (5 - i)
            s = math.sqrt(h * h + w * w)
            dev = head.of_flow.weight.device

            def t(a):
                return torch.from_numpy(a.astype(np.float32)).to(dev)

            head.of_flow.weight.copy_(
                t(rng.normal(0, k / s, (3, 3, 16, 2)).transpose(3, 2, 0, 1)))
            head.norm.weight.copy_(t(rng.uniform(0.5, 1.5, 16)))
            head.norm.bias.copy_(t(rng.normal(0, 0.1, 16)))
            head.norm.running_mean.copy_(t(rng.normal(0, 0.1, 16)))
            head.norm.running_var.copy_(t(rng.uniform(0.5, 1.5, 16)))


def build(dtype, dev, hw=(H, W), k=1.5, **kw):
    """build_flow_net from SEED with flow heads seeded for inputs of
    size hw (k = 0: the fresh 'diag' heads, zero flow)."""
    from qpwcnet_torch.models import build_flow_net

    model = build_flow_net(SEED, dev, dtype=dtype, **kw)
    if k:
        seed_flow_heads(model, SEED + 1, hw, k=k)
    return model


def build_train(dtype, dev, k=TRAIN_K, **kw):
    return build(dtype, dev, hw=(TRAIN_H, TRAIN_W), k=k, **kw)


def build_interp(dtype, dev, k, **kw):
    """build_interpolator from SEED with flow heads seeded for inputs of
    256x512 (k = 0: the fresh 'diag' heads)."""
    from qpwcnet_torch.models import build_interpolator

    model = build_interpolator(SEED, dev, dtype=dtype, **kw)
    if k:
        seed_flow_heads(model, SEED + 1, (TRAIN_H, TRAIN_W), k=k)
    return model


def counts_of(K1=0, K2=0, K3=0, K4a=0, K4b=0, K5=0, K1h=0, K4ah=0,
              K4bh=0) -> dict:
    """Launch counts by wrapper name (qpwcnet_torch.ops.cuda); K1h,
    K4ah, K4bh: the haloed modes."""
    return {"cost_volume_cuda": K1, "downconv_stage_cuda": K2,
            "warp_cost_volume_cuda": K3, "cost_volume_bwd_prv_cuda": K4a,
            "cost_volume_bwd_nxt_cuda": K4b, "upconv_stage_cuda": K5,
            "cost_volume_haloed_cuda": K1h,
            "cost_volume_bwd_prv_haloed_cuda": K4ah,
            "cost_volume_bwd_nxt_haloed_cuda": K4bh}


def k_only(counts: dict) -> dict:
    """The K1-K5 wrappers' part of a launch_counts() reading."""
    return {k: counts[k] for k in counts_of()}


def launches(fn):
    """fn()'s result and the launch counts of its run, counted from 0."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def epilogue_ran(counts: dict) -> None:
    """The bias + Mish forward kernel ran (every configuration runs 25 or
    more Mish convs a forward), and its backward wherever the cost
    volume's backward ran."""
    bwd = (counts["cost_volume_bwd_prv_cuda"]
           + counts["cost_volume_bwd_prv_haloed_cuda"])
    assert counts["bias_mish_cuda"] > 0, counts
    assert counts["bias_mish_bwd_cuda"] > 0 or not bwd, counts


def main_path(counts: dict, **want) -> None:
    """A main path's launches: exactly ``counts_of(**want)`` of K1-K5, and
    the bias + Mish kernels (epilogue_ran)."""
    assert k_only(counts) == counts_of(**want), counts
    epilogue_ran(counts)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def compare_model(got, want, dtype) -> None:
    """A model output against the plain model's: float32 within 1e-4 of
    the magnitude (five levels of convs in another summation order feed
    the warp coordinates: the JAX parity bound of
    tests/test_torch_model.py); bf16 within 5% of it max and 0.5% mean (a
    one-ulp difference early moves later warps)."""
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.abs().max()))
    err = max_err(got, want)
    rel = 1e-4 if dtype == F32 else 5e-2
    assert err <= rel * scale, (err, rel * scale)
    if dtype != F32:
        mean = float((got - want).abs().mean())
        assert mean <= 5e-3 * scale, (mean, 5e-3 * scale)


@contextlib.contextmanager
def plain_epilogue():
    """Every caller of the bias + Mish epilogue (each looks up
    ``mish_kernel.bias_mish_cuda``) runs the composition instead of the
    kernels: a plain model then runs no hand-written kernel, so the
    gradient checks hold the kernel models, the bias + Mish kernels among
    them, against plain PyTorch."""
    from qpwcnet_torch.ops.cuda import mish_kernel

    saved = mish_kernel.bias_mish_cuda
    mish_kernel.bias_mish_cuda = mish_kernel.bias_mish_plain
    try:
        yield
    finally:
        mish_kernel.bias_mish_cuda = saved


def grad_step(model, batch, make_step=None, plain=False):
    """One train step (make_flow_train_step unless ``make_step`` names
    another step maker) with the plain chain at learning rate 0, so the
    parameters stay as they were; ``plain``: under plain_epilogue().
    Returns (loss, {name: grad}, launch counts of the step)."""
    from qpwcnet_torch.train import make_flow_train_step, plain_optimizer

    opt = plain_optimizer(model, 0.0)
    with plain_epilogue() if plain else contextlib.nullcontext():
        m, counts = launches(
            lambda: (make_step or make_flow_train_step)()(model, opt, batch))
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    loss = float(m["loss"])
    assert np.isfinite(loss), loss
    return loss, grads, counts


# Leaves whose gradient is the small remainder of a near-total
# cancellation: they feed a flow head's train-mode BatchNorm, directly or
# through its 1x1 conv, and BatchNorm removes any per-channel shift.
CANCELLING = ("conv1x1.bias", "of_feats.3.pointwise.bias")


def grad_scale(name, want) -> float:
    """The magnitude a leaf's float32 gradient error is measured against:
    its own max|g|, or for a cancelling leaf the largest max|g| in its
    flow head (the size of the terms that cancel)."""
    if not name.endswith(CANCELLING):
        return float(want[name].abs().max())
    head = name.split(".flow.")[0] + ".flow."
    return max(float(w.abs().max()) for n, w in want.items()
               if n.startswith(head))


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def compare_grads(got, want, ref32=None) -> None:
    """Every leaf against the plain model's. float32: max|got - want| <=
    1e-4 of grad_scale, the port's model bound (five levels of convs in
    another summation order feed the warp coordinates). bf16 (``ref32``
    holds the plain model's float32 gradients): the kernels may add no
    more error than bf16 compute itself, rms(got - want) <=
    BF16_GRAD_FACTOR * rms(want - ref32), plus 1e-6 of the leaf's max for
    the leaves that bf16 leaves exact. A bound relative to the leaf's own
    max would be meaningless in bf16 for the cancelling leaves, whose
    noise is relative to the cancelled terms."""
    bad = []
    for name, w in want.items():
        assert bool(torch.isfinite(got[name]).all()), name
        d = got[name] - w
        if ref32 is None:
            r = float(d.abs().max()) / max(grad_scale(name, want), 1e-30)
            used = r / 1e-4
        else:
            noise = rms(w - ref32[name])
            floor = 1e-6 * float(ref32[name].abs().max())
            used = rms(d) / (BF16_GRAD_FACTOR * noise + floor)
        if used > 1.0:
            bad.append((name, used))
    assert not bad, bad


def grad_steps(dev, batch, modes, build_fn=build_train, make_step=None,
               per_step=None):
    """Each of ``modes`` ({mode: build kwargs}; the last one plain) in
    float32 and then bf16: one step's loss, gradients and launches
    (``per_step[mode]``, none for the plain model), and every kernel
    mode's gradients against the plain model's (compare_grads, the plain
    float32 gradients the bf16 noise floor). Returns the bf16 steps'
    launches by mode."""
    plain32, counts = None, {}
    *kernel_modes, plain = modes
    for dtype in (F32, BF16):
        grads = {}
        for mode, kw in modes.items():
            _, grads[mode], counts[mode] = grad_step(
                build_fn(dtype, dev, **kw), batch, make_step,
                plain=mode == plain)
            want = counts_of() if mode == plain else per_step[mode]
            assert k_only(counts[mode]) == want, (mode, dtype, counts[mode])
            torch.cuda.empty_cache()
        for mode in kernel_modes:
            compare_grads(grads[mode], grads[plain], plain32)
        plain32 = grads[plain]
    return counts


def loss_falls(model, make_step, batch) -> None:
    """5 Adam steps (learning rate 3e-4) on one batch: the loss falls."""
    from qpwcnet_torch.train import plain_optimizer

    opt = plain_optimizer(model, 3e-4)
    step = make_step()
    losses = [float(step(model, opt, batch)["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def finest_flow_in(model, ims):
    """2x the flow entering the finest UpFlow, where 'fast' clamps."""
    with torch.no_grad():
        return 2.0 * model(ims, multiscale=True)[-3].abs()


def interp_forward_matches(dev, ims, kernel_kw, dtype, per_fwd) -> None:
    """The interpolator's eval forward with ``kernel_kw`` against the
    plain interpolator: its launches, the image and the worst of each
    direction's six flows (compare_model)."""
    outs = {}
    with torch.inference_mode():
        for mode, kw in (("kernel", kernel_kw), ("plain", PLAIN_KW)):
            m = build_interp(dtype, dev, k=1.5, **kw)
            outs[mode], counts = launches(lambda: m(ims, return_flows=True))
            want = per_fwd if mode == "kernel" else counts_of()
            assert k_only(counts) == want, (mode, counts)
            img = outs[mode][0]
            assert tuple(img.shape) == (INTERP_B, TRAIN_H, TRAIN_W, 3)
            assert img.dtype == F32
            del m
        compare_model(outs["kernel"][0], outs["plain"][0], dtype)
        for d in range(2):
            worst = max(range(6), key=lambda i: max_err(
                outs["kernel"][1][d][i], outs["plain"][1][d][i]))
            compare_model(outs["kernel"][1][d][worst],
                          outs["plain"][1][d][worst], dtype)


def interp_entry_points(dev, ibatch, kw, n_steps=2):
    """The library entry points as a user calls them (bench.py drives the
    JAX pretraining step so): build_interpolator, 2 make_interp_train_step
    steps on fresh augmented batches, then one eval forward, bf16. Returns
    the launches."""
    from qpwcnet_torch.models import build_interpolator
    from qpwcnet_torch.train import (
        create_interp_train_state, make_interp_train_step)

    def run():
        model = build_interpolator(SEED, dev, dtype=BF16, **kw)
        opt = create_interp_train_state(model, 1e-4)
        step = make_interp_train_step()
        metrics = [step(model, opt, interp_batch(dev, SEED + 9 + i, True))
                   for i in range(n_steps)]
        model.eval()
        with torch.no_grad():
            img = model(ibatch["ims"])
        return [float(mt["loss"]) for mt in metrics], img

    (losses, img), counts = launches(run)
    assert all(np.isfinite(losses)) and bool(torch.isfinite(img).all())
    return counts


# -------------------------------------- the flow net at 448x1024 b8

# each model's launches a forward
FWD = {"exact": dict(K1=5, K2=2), "fast": dict(K1=4, K2=2, K3=1),
       "plain": {}}

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_flow_net_matches_plain(dev, x, dtype):
    """Exact, 'fast' and plain at the headline: the output's shape, dtype
    and finiteness, each kernel's launches a forward (FWD), flows beyond
    the fused window at the finest level (else 'fast''s window clamp would
    go untried), exact against plain."""
    flows = {}
    with torch.inference_mode():
        for mode, kw in MODES.items():
            m = build(dtype, dev, **kw)
            out, counts = launches(lambda: m(x))
            assert tuple(out.shape) == (B, H, W, 2) and out.dtype == F32
            assert bool(torch.isfinite(out).all()), mode
            assert k_only(counts) == counts_of(**FWD[mode]), (mode, counts)
            flows[mode] = out
            if mode == "plain":
                beyond = float((finest_flow_in(m, x) > 4.0).float().mean())
                assert beyond > 0.0, "no flow beyond the fused window"
            del m
        compare_model(flows["exact"], flows["plain"], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_flow_net_replays_bit_for_bit(dev, x, mode, n=6):
    """The benchmark's main path at the headline (bf16, inference mode):
    n calls on distinct inputs, x first; the first runs eagerly, the
    second captures the forward's CUDA graph and the rest copy their
    input in and replay. Every output, all held to the end, is bit for
    bit the eager forward of its input; the replays count n - 2 and the
    kernel launches n forwards."""
    from qpwcnet_torch.utils import tracing

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    xs = [x] + [torch.rand(x.shape, generator=g, device=dev) - 0.5
                for _ in range(n - 1)]
    with torch.inference_mode():
        m = build(BF16, dev, **MODES[mode])
        before = tracing.counts().get("flow_net.graph_replays", 0)
        outs, counts = launches(lambda: [m(xi) for xi in xs])
        replays = tracing.counts().get("flow_net.graph_replays", 0) - before
        same = [torch.equal(o, m._forward(xi, False))
                for o, xi in zip(outs, xs)]
    assert replays == n - 2, replays
    assert all(same), same
    main_path(counts, **{k: n * v for k, v in FWD[mode].items()})
    assert counts["bias_mish_cuda"] == n * 38, counts


@pytest.mark.cuda
@pytest.mark.parametrize("cv_impl", ["auto", "fast"])
def test_flow_net_card_matches_cpu(dev, cv_impl):
    """The float32 model on the card (kernels) against the same model on
    the CPU (plain versions) at 64x128: 1e-4 of the flow magnitude."""
    xs = torch.rand((1, 64, 128, 6),
                    generator=torch.Generator().manual_seed(SEED + 3)) - 0.5
    cpu = build(F32, "cpu", hw=(64, 128), cv_impl=cv_impl, stem_stages=2)
    gpu = build(F32, dev, hw=(64, 128), cv_impl=cv_impl, stem_stages=2)
    with torch.no_grad():
        ref = cpu(xs)
        err = max_err(gpu(xs.to(dev)).cpu(), ref)
    assert err <= 1e-4 * max(1.0, float(ref.abs().max())), err


@pytest.mark.cuda
def test_infer_app(dev, tmp_path):
    """The infer app (--fast, 2 requests at 448x1024, seeded heads), a
    main path: finite warp-validation errors, 10 PNGs, K1 8, K2 4, K3 2,
    and bias + Mish after each of the 38 Mish convs that run as modules
    at stem_stages=2, in each of the 2 forwards."""
    from qpwcnet_torch.apps import infer
    from qpwcnet_torch.utils.config import parse_config

    cfg = parse_config(infer.Settings, [
        "--fast", "true", "--n", "2", "--height", str(H), "--width", str(W),
        "--out-dir", str(tmp_path), "--device", str(dev)])
    model = infer.build_model(cfg)
    seed_flow_heads(model, SEED + 1, (H, W))
    errs, counts = launches(lambda: infer.run(cfg, model))
    assert len(errs) == 2 and all(np.isfinite(errs)), errs
    assert len(list(tmp_path.glob("*.png"))) == 10
    main_path(counts, K1=8, K2=4, K3=2)
    assert (counts["bias_mish_cuda"], counts["bias_mish_bwd_cuda"]) == \
        (2 * 38, 0), counts


# ----------------------------------- the flow train step at 256x512 b16

TRAIN_PER_STEP = {"exact": counts_of(K1=5, K2=2, K4a=5, K4b=5),
                  "fast": counts_of(K1=5, K2=2, K3=1, K4a=5, K4b=5)}


@pytest.mark.cuda
def test_train_step_grads_match_plain(dev, batch, deterministic):
    """One train step of the exact, 'fast' and plain models (seeded
    heads), float32 and bf16: finite losses, each kernel's launches a
    step, every parameter's gradient against the plain model's."""
    grad_steps(dev, batch, MODES, per_step=TRAIN_PER_STEP)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_train_flow_stays_inside_the_window(dev, batch, dtype):
    """The train step's seeded flows (train mode) stay inside 'fast''s ±4
    window at the finest level, so 'fast' computes the plain model's
    function there."""
    m = build_train(dtype, dev, **MODES["plain"]).train()
    assert float(finest_flow_in(m, batch["ims"]).max()) < 4.0


@pytest.mark.cuda
def test_plain_bf16_train_step_repeats(dev, batch, deterministic):
    """R6: the plain bf16 step, run twice on fresh models, gives bit-equal
    gradients."""
    kw = MODES["plain"]
    runs = [grad_step(build_train(BF16, dev, **kw), batch, plain=True)[1]
            for _ in range(2)]
    differ = [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])]
    assert not differ, differ


@pytest.mark.cuda
def test_fresh_heads_grads_match_plain(dev, batch, deterministic):
    """Fresh 'diag' heads (zero flow at every level), float32: the exact
    model's gradients against the plain model's."""
    grads = {}
    for mode in ("exact", "plain"):
        _, grads[mode], counts = grad_step(
            build_train(F32, dev, k=0.0, **MODES[mode]), batch,
            plain=mode == "plain")
        assert k_only(counts) == TRAIN_PER_STEP.get(mode, counts_of())
    compare_grads(grads["exact"], grads["plain"])


@pytest.mark.cuda
def test_train_loss_falls(dev, batch, deterministic):
    from qpwcnet_torch.train import make_flow_train_step

    loss_falls(build_train(F32, dev, cv_impl="auto", stem_stages=2),
               make_flow_train_step, batch)


@pytest.mark.cuda
def test_train_app(dev, tmp_path, deterministic):
    """train_flow on synthetic data, 4 steps at 256x512 b16, a main path:
    K1 in every forward (steps, held-out evals, recalibration passes), K4a
    and K4b in every step's backward (cv_impl='auto', stem_stages=0), and
    bias + Mish after each of the 44 Mish convs in every forward and
    their backward in every step."""
    from qpwcnet_torch.apps import train_flow

    steps, log_every, recal = 4, 2, 16
    metrics, counts = launches(lambda: train_flow.main([
        "--data", "synthetic", "--steps", str(steps), "--curriculum", "",
        "--batch-size", str(TRAIN_B), "--height", str(TRAIN_H), "--width",
        str(TRAIN_W), "--log-every", str(log_every), "--recalibrate-final",
        str(recal), "--device", str(dev), "--run-root", str(tmp_path)]))
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    n_fwd = steps + steps // log_every + recal
    main_path(counts, K1=5 * n_fwd, K4a=5 * steps, K4b=5 * steps)
    assert (counts["bias_mish_cuda"], counts["bias_mish_bwd_cuda"]) == \
        (44 * n_fwd, 44 * steps), counts


# ------------------------------------ the interpolator at 256x512 b8

INTERP_PER_STEP = counts_of(K1=5, K2=2, K5=2, K4a=5, K4b=5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_interpolator_matches_plain(dev, ibatch, dtype, deterministic):
    """The eval forward (K1 5, K2 2, K5 2) against the plain
    interpolator: the image and both directions' flows."""
    interp_forward_matches(dev, ibatch["ims"], INTERP_KW, dtype,
                           counts_of(K1=5, K2=2, K5=2))


@pytest.mark.cuda
def test_flow_net_upconv_stages_matches_plain(dev, x, deterministic):
    """K5 in the flow net at the headline: upconv_stages=2, bf16, against
    the plain flow model."""
    outs = {}
    with torch.inference_mode():
        for mode, kw in (("exact", dict(INTERP_KW)), ("plain", PLAIN_KW)):
            m = build(BF16, dev, **kw)
            outs[mode], counts = launches(lambda: m(x))
            want = counts_of(K1=5, K2=2, K5=2) if mode == "exact" else \
                counts_of()
            assert k_only(counts) == want, (mode, counts)
            del m
    compare_model(outs["exact"], outs["plain"], BF16)


@pytest.mark.cuda
def test_pretraining_step_grads_match_plain(dev, ibatch, deterministic):
    """One pretraining step (seeded heads), float32 and bf16: each
    kernel's launches and every gradient against the plain model's."""
    from qpwcnet_torch.train import make_interp_train_step

    grad_steps(dev, ibatch, {"exact": INTERP_KW, "plain": PLAIN_KW},
               lambda dt, d, **kw: build_interp(dt, d, k=TRAIN_K, **kw),
               make_interp_train_step, {"exact": INTERP_PER_STEP})


@pytest.mark.cuda
def test_interp_loss_falls(dev, ibatch, deterministic):
    """The trainable head parameterization ('unit' + residual, fresh
    heads): under 'diag' the heads' output scale, sqrt(h² + w²) ~ 570
    here, turns Adam's first 3e-4 step on seeded heads into flows tens
    of px off, and the loss jumps before it falls."""
    from qpwcnet_torch.train import make_interp_train_step

    loss_falls(build_interp(F32, dev, k=0.0, head_scale="unit",
                            residual=True, **INTERP_KW),
               make_interp_train_step, ibatch)


@pytest.mark.cuda
def test_interp_entry_points(dev, ibatch, deterministic):
    """The library entry points (INTERP_KW), a main path."""
    n_fwd, n_steps = 3, 2
    main_path(interp_entry_points(dev, ibatch, INTERP_KW),
              K1=5 * n_fwd, K2=2 * n_fwd, K5=2 * n_fwd, K4a=5 * n_steps,
              K4b=5 * n_steps)


@pytest.mark.cuda
def test_pretrain_app(dev, tmp_path, deterministic):
    """pretrain_interp, 4 steps at 256x512 b8, a main path: K1 in every
    forward (steps, held-out evals, recalibration passes), K4a and K4b in
    every step's backward; no stem or upconv kernels (the JAX app's
    model)."""
    from qpwcnet_torch.apps import pretrain_interp

    steps, log_every, recal = 4, 2, 4
    metrics, counts = launches(lambda: pretrain_interp.main([
        "--steps", str(steps), "--batch-size", str(INTERP_B), "--height",
        str(TRAIN_H), "--width", str(TRAIN_W), "--log-every",
        str(log_every), "--recalibrate-final", str(recal), "--device",
        str(dev), "--run-root", str(tmp_path)]))
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert "mse_eval" in metrics
    n_fwd = steps + steps // log_every + recal
    main_path(counts, K1=5 * n_fwd, K4a=5 * steps, K4b=5 * steps)


@pytest.mark.cuda
def test_interp_infer_app(dev, tmp_path, deterministic):
    """interp_infer on 2 synthetic triplets at 256x512, a main path:
    finite PSNRs, 14 PNGs, K1 10."""
    from qpwcnet_torch.apps import interp_infer

    results, counts = launches(lambda: interp_infer.main([
        "--data", "synthetic", "--n", "2", "--height", str(TRAIN_H),
        "--width", str(TRAIN_W), "--out-dir", str(tmp_path), "--device",
        str(dev)]))
    assert len(results) == 2 and all(np.isfinite(r["psnr"])
                                     for r in results), results
    assert len(list(tmp_path.glob("*.png"))) == 14
    main_path(counts, K1=10)


# ------------- the fully fused configuration (stem_stages=5, upconv_stages=4)

FUSED_PER_STEP = {"exact": counts_of(K1=5, K2=5, K5=4, K4a=5, K4b=5),
                  "fast": counts_of(K1=5, K2=5, K3=1, K5=4, K4a=5, K4b=5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fused_flow_forward_matches_plain(dev, x, dtype, deterministic):
    """The flow forward at the headline, exact (K1 5, K2 5, K5 4) and
    'fast' (K1 4, K3 1, K2 5, K5 4), exact against the plain model; in
    bf16 both are main paths (fused_infer_exact, fused_infer_fast)."""
    fwd = {"auto": dict(K1=5, K2=5, K5=4),
           "fast": dict(K1=4, K2=5, K3=1, K5=4)}
    with torch.inference_mode():
        want = build(dtype, dev, **PLAIN_KW)(x)
        for cv, per in fwd.items():
            m = build(dtype, dev, cv_impl=cv, **FUSED_KW)
            out, counts = launches(lambda: m(x))
            assert k_only(counts) == counts_of(**per), counts
            if dtype == BF16:
                epilogue_ran(counts)
            if cv == "auto":
                compare_model(out, want, dtype)
            del m, out


@pytest.mark.cuda
def test_fused_train_step_grads_match_plain(dev, batch, deterministic):
    """The flow train step at 256x512 b16, exact and 'fast' (K4a 5, K4b 5
    too), every gradient against the plain model's; the bf16 exact step
    is a main path (fused_train)."""
    counts = grad_steps(dev, batch, {
        "exact": dict(cv_impl="auto", **FUSED_KW),
        "fast": dict(cv_impl="fast", **FUSED_KW), "plain": PLAIN_KW},
        per_step=FUSED_PER_STEP)
    epilogue_ran(counts["exact"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fused_interpolator_matches_plain(dev, ibatch, dtype,
                                          deterministic):
    interp_forward_matches(dev, ibatch["ims"],
                           dict(cv_impl="auto", **FUSED_KW), dtype,
                           counts_of(K1=5, K2=5, K5=4))


@pytest.mark.cuda
def test_fused_pretraining_step_grads_match_plain(dev, ibatch,
                                                  deterministic):
    from qpwcnet_torch.train import make_interp_train_step

    grad_steps(dev, ibatch, {"fused": dict(cv_impl="auto", **FUSED_KW),
                             "plain": PLAIN_KW},
               lambda dt, d, **kw: build_interp(dt, d, k=TRAIN_K, **kw),
               make_interp_train_step, {"fused": FUSED_PER_STEP["exact"]})


@pytest.mark.cuda
def test_fused_interp_loss_falls(dev, ibatch, deterministic):
    from qpwcnet_torch.train import make_interp_train_step

    loss_falls(build_interp(F32, dev, k=0.0, head_scale="unit",
                            residual=True, cv_impl="auto", **FUSED_KW),
               make_interp_train_step, ibatch)


@pytest.mark.cuda
def test_fused_interp_entry_points(dev, ibatch, deterministic):
    """The library entry points in the fully fused configuration, a main
    path (fused_interp)."""
    n_fwd, n_steps = 3, 2
    main_path(interp_entry_points(dev, ibatch,
                                  dict(cv_impl="auto", **FUSED_KW)),
              K1=5 * n_fwd, K2=5 * n_fwd, K5=4 * n_fwd, K4a=5 * n_steps,
              K4b=5 * n_steps)


# --------------------------- the H-sharded path on the local transport

def spatial_counts(h, n, step=False) -> dict:
    """The launches of one sharded forward (and with ``step`` its
    backward) at input height h in n shards: the levels with 4 rows a
    shard or more (r = 4) take the haloed modes, the coarser ones fall
    back to the whole level's unhaloed kernels."""
    whole = sum((h >> (5 - i)) // n < 4 for i in range(5))
    bwd = dict(K4a=whole, K4b=whole, K4ah=5 - whole, K4bh=5 - whole)
    return dict(K1=whole, K1h=5 - whole, **(bwd if step else {}))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_spatial_forward_matches_unsharded(dev, x, dtype, deterministic):
    """The headline forward in 2 H shards folded into the batch (warp
    halo 16; K1's haloed mode at all five levels) against the unsharded
    model (stem_stages=0): float32 within 2e-3 of the flow magnitude
    (JAX's own bound, tests/test_spatial.py), bf16 within phase 4's model
    bound (5% max, 0.5% mean); in bf16 a main path (spatial_infer)."""
    from qpwcnet_torch.parallel import (
        SpatialConfig, make_mesh, make_spatial_forward, shard_batch_spatial,
        unshard_batch_spatial)

    n = SPATIAL_N_FWD
    mesh = make_mesh(n_data=1, n_model=n)
    fwd = make_spatial_forward(lambda m, ims: m(ims), mesh)
    with torch.inference_mode():
        want = build(dtype, dev, cv_impl="auto", stem_stages=0)(
            x, multiscale=True)[-1]
        sp = build(dtype, dev, cv_impl="auto",
                   spatial=SpatialConfig(mesh, warp_halo=SPATIAL_HALO_FWD))
        out, counts = launches(lambda: fwd(sp, shard_batch_spatial(x, mesh)))
        got = unshard_batch_spatial(out, mesh)
    assert tuple(out.shape) == (n * B, H // n, W, 2)
    assert k_only(counts) == counts_of(**spatial_counts(H, n)), counts
    if dtype == BF16:
        epilogue_ran(counts)
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.abs().max()))
    err, mean = max_err(got, want), float((got - want).abs().mean())
    assert err <= (2e-3 if dtype == F32 else 5e-2) * scale, err
    if dtype == BF16:
        assert mean <= 5e-3 * scale, mean


@pytest.mark.cuda
def test_spatial_train_step_matches_unsharded(dev, batch, deterministic):
    """The train step at 256x512 b16 in 4 H shards (warp halo 8; the
    coarsest level falls back to the whole level's kernels) against the
    unsharded model, float32 and bf16: the loss (float32 within 1e-5,
    tests/test_spatial.py's; bf16 within 5e-3, the forward's mean bound),
    every gradient (compare_grads), the BatchNorm running statistics
    (float32 within 1e-5 of the magnitude, JAX's; bf16 within 1e-2,
    statistics of bf16 features); the bf16 step is a main path
    (spatial_train)."""
    from qpwcnet_torch.parallel import (
        SpatialConfig, make_mesh, make_spatial_train_step,
        shard_batch_spatial)
    from qpwcnet_torch.train import make_flow_train_step

    n = SPATIAL_N_TRAIN
    mesh = make_mesh(n_data=1, n_model=n)
    sbatch = {k: shard_batch_spatial(v, mesh) for k, v in batch.items()}
    per_step = counts_of(**spatial_counts(TRAIN_H, n, step=True))
    ref32 = None
    for dtype in (F32, BF16):
        ref = build_train(dtype, dev, cv_impl="auto", stem_stages=0)
        loss_u, g_u, counts_u = grad_step(ref, batch)
        sp = build_train(dtype, dev, cv_impl="auto",
                         spatial=SpatialConfig(
                             mesh, warp_halo=SPATIAL_HALO_TRAIN))
        loss_s, g_s, counts_s = grad_step(
            sp, sbatch,
            lambda: make_spatial_train_step(make_flow_train_step(), mesh))
        assert k_only(counts_u) == counts_of(K1=5, K4a=5, K4b=5), counts_u
        assert k_only(counts_s) == per_step, counts_s
        if dtype == BF16:
            epilogue_ran(counts_s)
        rel = 1e-5 if dtype == F32 else 5e-3
        assert abs(loss_s - loss_u) <= rel * max(1.0, abs(loss_u)), (
            loss_s, loss_u)
        compare_grads(g_s, g_u, ref32)
        bn_rel = 1e-5 if dtype == F32 else 1e-2
        stats = [(k, v) for k, v in ref.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))]
        sp_state = sp.state_dict()
        for name, b in stats:
            e = max_err(sp_state[name], b) / max(1.0, float(b.abs().max()))
            assert e <= bn_rel, (name, e)
        if dtype == F32:
            ref32 = g_u
        del ref, sp, g_u, g_s
        torch.cuda.empty_cache()
