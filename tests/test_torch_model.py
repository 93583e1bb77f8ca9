"""The PyTorch port's PWCFlowNet against the JAX model on CPU, with the
same Flax variables loaded into both.

Fresh weights make the check vacuous: the 'diag' flow heads start at
zero, so every flow is 0 and the warp is the identity. So every test here
first draws the of_flow kernels, the BatchNorm scale/bias/statistics and
the conv biases from a numpy seed, scaled so that the flows are a few
pixels with some beyond ±4 at the finest level, and loads the same tree
into both models.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.models.pwcnet import Flower
from tests.test_models import _expected_flow_net_params

HW = (64, 128)
LEVELS = ["flow_0"] + [f"upflow_{i}" for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread for the module's tests, restored
    after. The test workers share the machine's cores, and each torch
    op's thread pool waits on its slowest thread: with one pool a core per
    worker, the small ops of these models ran ten to fifty times slower
    than alone. A module that imports this fixture gets it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(variables, head_scale, seed=0, k=1.5, hw=HW):
    """A numpy copy of a Flax flow-net tree with non-zero flow heads and
    BatchNorm state. of_flow ~ N(0, (k / s)^2) with s = sqrt(h² + w²) of
    the level under 'diag' (1 under 'unit'). k = 1.5 gives flows of ~2 px
    with running statistics; batch statistics normalize the small
    head features up, so train mode takes a smaller k."""
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                               jax.device_get(variables))
    rng = np.random.RandomState(seed)

    def biases(tree):
        for k, sub in tree.items():
            if isinstance(sub, dict):
                if "bias" in sub and "kernel" in sub:
                    sub["bias"] = (0.05 * rng.standard_normal(
                        sub["bias"].shape)).astype(np.float32)
                biases(sub)

    biases(v["params"])
    for i, name in enumerate(LEVELS):
        h, w = hw[0] >> (5 - i), hw[1] >> (5 - i)
        s = float(h * h + w * w) ** 0.5 if head_scale == "diag" else 1.0
        head = v["params"]["flower"][name]["flow"]
        head["of_flow"]["kernel"] = rng.normal(
            0, k / s, (3, 3, 16, 2)).astype(np.float32)
        head["norm"]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        head["norm"]["bias"] = rng.normal(0, 0.1, 16).astype(np.float32)
        st = v["batch_stats"]["flower"][name]["flow"]["norm"]
        st["mean"] = rng.normal(0, 0.1, 16).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    return v


def _inputs(seed=0, hw=HW):
    return np.random.RandomState(seed).uniform(
        -0.5, 0.5, (1, *hw, 6)).astype(np.float32)


def _port(v, head_scale, **kw):
    model = build_flow_net(0, "cpu", head_scale=head_scale, **kw)
    return load_flax_variables(model, v)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def test_param_count_matches_golden():
    model = build_flow_net(0, "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == _expected_flow_net_params()


def test_load_flax_variables_maps_every_leaf(flow_setup):
    _, variables = flow_setup
    v = _seeded(variables, "diag")
    model = _port(v, "diag")
    leaves = jax.tree_util.tree_leaves(v)
    assert len(leaves) == 133
    assert sum(a.size for a in leaves) == 3_094_165
    assert len(model.state_dict()) == len(leaves)
    head = model.flower.upflows[3].flow
    np.testing.assert_array_equal(
        head.of_flow.weight.detach().numpy(),
        v["params"]["flower"]["upflow_3"]["flow"]["of_flow"]["kernel"]
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        head.norm.running_var.numpy(),
        v["batch_stats"]["flower"]["upflow_3"]["flow"]["norm"]["var"])
    bad = {"params": {**v["params"], "extra": {"kernel": np.zeros(1)}},
           "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError):
        load_flax_variables(build_flow_net(0, "cpu"), bad)
    short = {"params": v["params"]}
    with pytest.raises(ValueError):
        load_flax_variables(build_flow_net(0, "cpu"), short)


@pytest.mark.parametrize("head_scale", ["diag", "unit"])
def test_multiscale_flows_match_jax_train_mode(flow_setup, head_scale):
    """All 6 flows in train mode (BatchNorm on batch statistics on both
    sides) and the updated running statistics (Keras momentum .99)."""
    model_j, variables = flow_setup
    v = _seeded(variables, head_scale, k=0.5)
    x = _inputs(1)
    outs_j, upd = model_j.clone(head_scale=head_scale).apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model_t = _port(v, head_scale).train()
    with torch.no_grad():
        outs_t = model_t(torch.from_numpy(x), multiscale=True)
    assert len(outs_t) == len(outs_j) == 6
    fin = np.asarray(outs_j[-2])
    assert 0.5 < np.mean(np.abs(fin)) < 5.0, np.mean(np.abs(fin))
    assert np.mean(np.abs(fin) > 4.0) > 0.01
    for a, b in zip(outs_t, outs_j):
        assert a.shape == b.shape
        # five levels of f32 convs in another summation order feed the
        # warp coordinates: 1e-4 of the flow magnitude
        assert _err(a, b) <= 1e-4 * max(1.0, float(np.max(np.abs(b)))), \
            _err(a, b)
    for i, name in enumerate(LEVELS):
        st = upd["batch_stats"]["flower"][name]["flow"]["norm"]
        bn = (model_t.flower.flow_0 if i == 0
              else model_t.flower.upflows[i - 1]).flow.norm
        # batch statistics of f32 features: rounding-level agreement
        assert _err(bn.running_mean, st["mean"]) <= 1e-5
        assert _err(bn.running_var, st["var"]) <= 1e-5


@pytest.mark.parametrize("head_scale", ["diag", "unit"])
def test_final_flow_matches_jax_eval_mode(flow_setup, head_scale):
    model_j, variables = flow_setup
    v = _seeded(variables, head_scale, seed=1)
    x = _inputs(2)
    want = model_j.clone(head_scale=head_scale).apply(
        v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _port(v, head_scale)(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.mean(np.abs(np.asarray(want))) > 0.5
    assert _err(got, want) <= 1e-4 * max(1.0, float(np.max(np.abs(want))))


def test_final_flow_matches_jax_bf16(flow_setup):
    """bf16 compute, f32 params/BatchNorm/flow conv. Both sides round at
    the same points but their convs sum in other orders, and a bf16 ulp
    flip early on moves the warp coordinates of later levels: the
    tolerance is 5% of the flow magnitude, and the mean error must be
    well below it."""
    model_j, variables = flow_setup
    v = _seeded(variables, "diag", seed=2)
    x = _inputs(3)
    want = np.asarray(model_j.clone(dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port(v, "diag", dtype=torch.bfloat16)(
            torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.max(np.abs(want))))
    assert _err(got, want) <= 0.05 * scale, (_err(got, want), scale)
    assert float(np.mean(np.abs(got - want))) <= 0.005 * scale


def test_fuse_batch_is_exact():
    torch.manual_seed(0)
    x = torch.rand(2, 64, 64, 6) - 0.5
    a = build_flow_net(0, "cpu", head_scale="unit")
    b = build_flow_net(0, "cpu", head_scale="unit", fuse_batch=False)
    with torch.no_grad():
        assert float((a(x) - b(x)).abs().max()) <= 1e-5


def test_fast_preset_fuses_only_the_finest_level():
    fl = Flower(cv_impl="fast")
    assert [fl.impl_at(i) for i in range(5)] == ["auto"] * 4 + ["fused"]
    model = build_flow_net(0, "cpu", cv_impl="fast")
    assert model.flower.flow_0.cv_impl == "auto"
    assert [u.cv_impl for u in model.flower.upflows] == \
        ["auto", "auto", "auto", "fused"]


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "qpwcnet_tpu")


def _forbidden_imports(path: Path) -> list[str]:
    """Every import of a forbidden top-level package in one file, at any
    depth (inside functions too)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [f"{path}:{node.lineno} {n}" for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


@pytest.mark.parametrize("check", ["static", "subprocess"])
def test_port_imports_no_jax(check):
    """The port package, the card's tests and tools (kernel_times.py,
    tests/test_torch_cuda*.py, tests/test_torch_flow_graph.py) and every
    module they hold import neither jax (nor flax, optax or orbax) nor
    the JAX package: statically, every ``import`` and ``from`` in every
    file (including imports inside functions, which run only on some
    paths); and at run time, the modules imported in a fresh
    interpreter."""
    root = Path(__file__).resolve().parents[1]
    if check == "static":
        files = sorted((root / "qpwcnet_torch").rglob("*.py"))
        assert len(files) > 40
        card = [root / "kernel_times.py",
                *sorted((root / "tests").glob("test_torch_cuda*.py")),
                root / "tests" / "test_torch_flow_graph.py"]
        assert len(card) == 5
        bad = [b for f in files + card for b in _forbidden_imports(f)]
        assert not bad, bad
        return
    code = ("import sys, qpwcnet_torch, qpwcnet_torch.models, "
            "qpwcnet_torch.apps.infer, qpwcnet_torch.ops.cuda, "
            "qpwcnet_torch.train, qpwcnet_torch.data, "
            "qpwcnet_torch.data.sintel, qpwcnet_torch.apps.train_flow, "
            "qpwcnet_torch.apps.pretrain_interp, "
            "qpwcnet_torch.apps.convert_quant, qpwcnet_torch.quantize, "
            "qpwcnet_torch.apps.interp_infer, "
            "qpwcnet_torch.apps.eval_sintel, qpwcnet_torch.utils.runs, "
            "qpwcnet_torch.train.checkpoint, qpwcnet_torch.train.metrics, "
            "qpwcnet_torch.apps.data_tools, qpwcnet_torch.data.triplet, "
            "qpwcnet_torch.data.fchairs3d, qpwcnet_torch.utils.cache, "
            "qpwcnet_torch.vis, qpwcnet_torch.train.schedules, "
            "qpwcnet_torch.ops.occlusion, qpwcnet_torch.ops.flow_vis, "
            "qpwcnet_torch.utils.profiling, qpwcnet_torch.apps.show_network, "
            "qpwcnet_torch.quantize.int8, qpwcnet_torch.parallel.spatial; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; "
            "assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": str(root)}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_sintel_reader_matches_jax(tmp_path):
    """The port's own copy of the Sintel TFRecord reader (which the infer
    app's --data sintel uses) reads a shard written by the JAX package's
    writer as the JAX reader does."""
    from qpwcnet_torch.data.flo_format import read_flo, write_flo
    from qpwcnet_torch.data.sintel import sintel_tfrecord_iterator
    from qpwcnet_tpu.data.flo_format import read_flo as j_read_flo
    from qpwcnet_tpu.data.sintel import (
        sintel_tfrecord_iterator as j_iterator,
    )
    from qpwcnet_tpu.data.tfrecord import make_sintel_example, write_tfrecord

    from qpwcnet_torch.vis import write_png

    rng = np.random.RandomState(0)
    records = []
    for i in range(2):
        pngs = []
        for j in range(2):
            write_png(tmp_path / f"{i}{j}.png",
                      rng.randint(0, 256, (6, 10, 3)).astype(np.uint8))
            pngs.append((tmp_path / f"{i}{j}.png").read_bytes())
        flo = rng.uniform(-5, 5, (6, 10, 2)).astype(np.float32)
        records.append(make_sintel_example(*pngs, flo))
    shard = tmp_path / "sintel-00-of-01.tfrecord"
    assert write_tfrecord(shard, records) == 2
    # an absolute glob for the port's reader, the path list for JAX's
    # (whose Path().glob refuses absolute patterns)
    got = list(sintel_tfrecord_iterator(str(tmp_path / "sintel-*")))
    want = list(j_iterator([shard]))
    assert len(got) == len(want) == 2
    for (gi, gf), (wi, wf) in zip(got, want):
        assert gi.shape == (6, 10, 6) and gi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gf, wf)
    # the infer app's --data sintel reads through the port's copy
    from qpwcnet_torch.apps import infer

    errs = infer.main(["--data", "sintel", "--data-path",
                       str(tmp_path / "sintel-*"), "--n", "2", "--height",
                       "32", "--width", "64", "--device", "cpu",
                       "--out-dir", str(tmp_path / "out")])
    assert len(errs) == 2 and all(np.isfinite(errs))
    write_flo(tmp_path / "a.flo", want[0][1])
    np.testing.assert_array_equal(read_flo(tmp_path / "a.flo"),
                                  j_read_flo(tmp_path / "a.flo"))
