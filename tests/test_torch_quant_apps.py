"""The quantization slice's apps and artifacts on CPU: train_flow --qat and
pretrain_interp --qat, a float checkpoint restored into a QAT model, a
QAT run interrupted and resumed (bit-equal, ranges included, and the same
int8 bundle), convert_to_int8 on carried weights against the JAX
package's (every array of the bundle equal, in JAX's order and dtypes),
the bundle read by the other package both ways, the convert_quant app
(fresh calibration, --load-ckpt, the --float-ckpt EPE gate, --check,
--export), and the QAT ranges over two gloo processes against one
process's over the whole batch (this file spawns itself as a script, one
process a rank, as tests/test_torch_spatial_mp.py does; the children
import no JAX).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qpwcnet_torch.apps import convert_quant, pretrain_interp, train_flow
from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.models.from_flax import to_flax_quant_stats
from qpwcnet_torch.quantize import (
    QConv,
    QuantConfig,
    convert_to_int8,
    load_int8_bundle,
    save_int8_bundle,
)
from qpwcnet_torch.quantize.qlayers import quant_ranges
from qpwcnet_torch.train import CheckpointManager, default_optimizer

ROOT = Path(__file__).resolve().parents[1]
B, C, H, W = 4, 6, 12, 16

if __name__ != "__main__":
    from qpwcnet_tpu.quantize.int8 import convert_to_int8 as j_convert
    from qpwcnet_tpu.quantize.int8 import load_int8_bundle as j_load
    from qpwcnet_tpu.quantize.int8 import save_int8_bundle as j_save
    from tests.test_torch_checkpoint import (
        PRETRAIN_ARGS,
        TRAIN_ARGS,
        _assert_states_equal,
        _state,
    )
    from tests.test_torch_model import _seeded
    from tests.test_torch_model import one_torch_thread  # noqa: F401


# ----------------------------------------------------------------- the apps

def _ranges_of(state):
    return {k: v for k, v in state["model"].items() if "amax" in k}


def test_train_flow_qat(tmp_path):
    """--qat: the QAT model trains, its checkpoint carries the 118 range
    buffers (set by the steps), and the final recalibration leaves the
    ranges of the last step."""
    runs = tmp_path / "runs"
    metrics = train_flow.main(TRAIN_ARGS + ["--qat", "true", "--steps", "3",
                                            "--run-root", str(runs)])
    assert np.isfinite(metrics["loss"])
    ckpt = runs / "000" / "ckpt"
    assert CheckpointManager(ckpt).all_steps() == [2, 3]
    ranges = _ranges_of(_state(ckpt, 3))
    assert len(ranges) == 118
    assert all(float(r.max()) > 0.0 for r in ranges.values())


def test_pretrain_interp_qat(tmp_path):
    runs = tmp_path / "runs"
    metrics = pretrain_interp.main(PRETRAIN_ARGS + [
        "--qat", "true", "--steps", "2", "--run-root", str(runs)])
    assert np.isfinite(metrics["loss"])
    ranges = _ranges_of(_state(runs / "000" / "ckpt", 2))
    assert len(ranges) == 118 + 5 * 5  # the five image heads' convs
    assert all(float(r.max()) > 0.0 for r in ranges.values())


def test_float_checkpoint_into_qat(tmp_path):
    """A float checkpoint restores into a QAT model (JAX's QAT fine-tune
    of a float run): parameters, BatchNorm statistics and the Adam state
    load, the ranges keep the model's (zero) values; train_flow --qat
    --load-ckpt of the float run continues from its step. A QAT
    checkpoint does not load into a float model."""
    runs = tmp_path / "runs"
    train_flow.main(TRAIN_ARGS + ["--steps", "2", "--run-root", str(runs)])
    ckpt = runs / "000" / "ckpt"
    model = build_flow_net(0, "cpu", quant=QuantConfig())
    chain = default_optimizer(model)
    assert CheckpointManager(ckpt).restore(model, chain) == 2
    saved = _state(ckpt, 2)["model"]
    for k, v in model.state_dict().items():
        if k in saved:
            assert torch.equal(v, saved[k]), k
        else:
            assert "amax" in k and float(v.abs().max()) == 0.0, k
    train_flow.main(TRAIN_ARGS + ["--qat", "true", "--steps", "4",
                                  "--load-ckpt", str(ckpt), "--run-root",
                                  str(runs)])
    qat = _state(runs / "001" / "ckpt", 4)
    assert qat["step"] == 4 and len(_ranges_of(qat)) == 118
    with pytest.raises(RuntimeError):
        CheckpointManager(runs / "001" / "ckpt").restore_params(
            build_flow_net(0, "cpu", head_scale="unit", residual=True))


def test_qat_resume_is_bit_equal_and_gives_the_same_bundle(tmp_path):
    """train_flow --qat: 4 steps, against 2 steps and a resume to 4: the
    final checkpoints are bit-equal, ranges included, and convert_quant
    --load-ckpt of each writes the same bundle."""
    runs = tmp_path / "runs"
    args = TRAIN_ARGS + ["--qat", "true", "--run-root", str(runs)]
    train_flow.main(args + ["--steps", "4"])
    train_flow.main(args + ["--steps", "2"])
    train_flow.main(args + ["--steps", "4", "--load-ckpt",
                            str(runs / "001" / "ckpt")])
    a, b = _state(runs / "000" / "ckpt", 4), _state(runs / "002" / "ckpt", 4)
    _assert_states_equal(a, b)
    assert len(_ranges_of(a)) == 118
    bundles = []
    for run in ("000", "002"):
        out = tmp_path / f"{run}.npz"
        convert_quant.main(["--device", "cpu", "--height", "32", "--width",
                            "64", "--load-ckpt", str(runs / run / "ckpt"),
                            "--check", "false", "--out", str(out)])
        bundles.append(np.load(out))
    assert bundles[0].files == bundles[1].files
    for k in bundles[0].files:
        np.testing.assert_array_equal(bundles[0][k], bundles[1][k])


# --------------------------------------------------------------- the bundle

@pytest.fixture(scope="module")
def carried(flow_setup):
    """A Flax flow-net tree with seeded weights and positive ranges (the
    per-channel ones with a few zero channels, which quantize with scale
    1), and the port's model holding it."""
    _, variables = flow_setup
    v = _seeded(variables, "diag", seed=3)
    model = build_flow_net(0, "cpu", quant=QuantConfig())
    rng = np.random.RandomState(4)

    def ranges(tree):
        out = {}
        for k, sub in tree.items():
            if isinstance(sub, dict):
                out[k] = ranges(sub)
            else:
                r = rng.uniform(0.1, 4.0, np.shape(sub)).astype(np.float32)
                if r.ndim:
                    r[:3] = 0.0
                out[k] = r
        return out

    v["quant_stats"] = ranges(to_flax_quant_stats(model))
    return v, load_flax_variables(model, v)


def test_convert_to_int8_matches_jax(carried, tmp_path):
    """Every conv: the same name, in the same order, and int8 kernel,
    scales, input range and bias equal to JAX's, dtypes included; the
    saved .npz files hold the same arrays under the same names in the
    same order."""
    v, model = carried
    want = j_convert(v["params"], v["quant_stats"])
    got = convert_to_int8(model)
    assert list(got) == list(want) and len(got) == 69
    for name, w in want.items():
        g = got[name]
        for f in ("kernel_i8", "w_scale", "bias"):
            a, b = getattr(g, f), getattr(w, f)
            if b is None:
                assert a is None, (name, f)
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, (name, f)
            assert a.tobytes() == b.tobytes(), (name, f)
        assert type(g.in_amax) is type(w.in_amax), name
        np.testing.assert_array_equal(g.in_amax, w.in_amax)
    save_int8_bundle(tmp_path / "port.npz", got)
    j_save(tmp_path / "jax.npz", want)
    p, j = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert p.files == j.files
    for k in j.files:
        assert p[k].dtype == j[k].dtype and p[k].tobytes() == j[k].tobytes()


def test_bundle_cross_loads(carried, tmp_path):
    """A bundle written by either package loads in the other, equal."""
    v, model = carried
    save_int8_bundle(tmp_path / "port.npz", convert_to_int8(model))
    j_save(tmp_path / "jax.npz", j_convert(v["params"], v["quant_stats"]))
    for a, b in ((load_int8_bundle(tmp_path / "jax.npz"),
                  j_load(tmp_path / "jax.npz")),
                 (j_load(tmp_path / "port.npz"),
                  load_int8_bundle(tmp_path / "port.npz"))):
        assert list(a) == list(b)
        for name in a:
            for f in ("kernel_i8", "w_scale", "bias", "in_amax"):
                np.testing.assert_array_equal(getattr(a[name], f),
                                              getattr(b[name], f))


# --------------------------------------------------------------- convert_quant

CQ_ARGS = ["--device", "cpu", "--height", "32", "--width", "64"]


def test_convert_quant_fresh_and_check(tmp_path, capsys):
    """No checkpoint: 2 calibration QAT steps populate the ranges; the
    bundle holds 69 convs; --check reports the int8 model against the
    float one."""
    out = convert_quant.main(CQ_ARGS + ["--steps", "2", "--out",
                                        str(tmp_path / "b.npz")])
    err = capsys.readouterr().err
    assert "calibrating ranges with 2 QAT steps" in err
    assert "int8 vs float flow: mean|delta|=" in err
    assert out["n_convs"] == 69 and out["n_int8_weights"] == 3_090_837
    assert np.isfinite(out["check_pct"])
    bundle = load_int8_bundle(tmp_path / "b.npz")
    assert max(float(np.max(c.in_amax)) for c in bundle.values()) > 0


def test_convert_quant_float_ckpt_gate(tmp_path, capsys):
    """--float-ckpt: QAT fine-tune, joint calibration, then the int8 and
    float EPEs (one JSON line on stderr); the conversion follows."""
    import json

    runs = tmp_path / "runs"
    train_flow.main(TRAIN_ARGS + ["--steps", "2", "--head-scale", "diag",
                                  "--residual", "false", "--run-root",
                                  str(runs)])
    capsys.readouterr()
    out = convert_quant.main(CQ_ARGS + [
        "--float-ckpt", str(runs / "000" / "ckpt"), "--qat-steps", "2",
        "--calib-passes", "2", "--gate-batches", "1", "--gate-batch-size",
        "2", "--check", "false", "--out", str(tmp_path / "g.npz")])
    line = [s for s in capsys.readouterr().err.splitlines()
            if s.startswith("{")]
    gate = json.loads(line[0])
    assert gate == out["gate"]
    assert np.isfinite(gate["epe_float"]) and np.isfinite(gate["epe_int8"])
    assert (tmp_path / "g.npz").is_file()


def test_convert_quant_export(tmp_path):
    """export_int8: an int8 conv chain exports with torch.export on the
    CPU and the loaded program computes the same; a forward the exporter
    cannot trace raises the exporter's own error."""
    conv = QConv(4, 8, quant=QuantConfig(mode="int8"))
    with torch.no_grad():
        conv.weight.normal_(generator=torch.Generator().manual_seed(0))
        conv.amax_in.fill_(1.0)
        conv.act_quant.amax.fill_(2.0)
    conv.eval()
    x = torch.rand(1, 4, 6, 8) - 0.5
    convert_quant.export_int8(conv, tmp_path / "c.pt2", x)
    loaded = torch.export.load(str(tmp_path / "c.pt2")).module()
    assert torch.equal(loaded(x), conv(x))

    class Opaque(torch.nn.Module):
        def forward(self, t):
            return torch.from_numpy(t.numpy() * 2)

    with pytest.raises(RuntimeError, match="numpy"):
        convert_quant.export_int8(Opaque(), tmp_path / "o.pt2", x)
    assert not (tmp_path / "o.pt2").exists()


# ------------------------------------------------------- ranges over a mesh

def _mesh_convs():
    """A per-channel-input 3x3 conv and a per-tensor 1x1 conv after it,
    QAT, with seeded weights."""
    pc = QConv(C, 8, 3, quant=QuantConfig(), per_channel_in=True)
    pt = QConv(8, 8, 1, quant=QuantConfig())
    with torch.no_grad():
        for m in (pc, pt):
            m.weight.normal_(generator=torch.Generator().manual_seed(1))
    return pc, pt


def _batches():
    rng = np.random.RandomState(2)
    xs = []
    for scale in (1.0, 1.5):
        x = rng.uniform(-1, 1, (B, C, H, W)).astype(np.float32) * scale
        x[B // 2:, :2] *= 10.0  # the large values in the second half
        xs.append(torch.from_numpy(x))
    return xs


def _ranges_after(convs, xs) -> dict:
    """Two train-mode passes (the batch absmax, then the EMA) through
    the two convs; their range buffers."""
    pc, pt = convs
    for x in xs:
        pt.train()(pc.train()(x))
    return {f"{i}.{k}": v.clone()
            for i, m in enumerate(convs) for k, v in quant_ranges(m).items()}


def _child(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from qpwcnet_torch.parallel import (
        initialize_distributed,
        make_mesh,
        use_mesh,
    )
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo",
                           timeout_s=60.0)
    mesh = make_mesh(n_data=world)
    n = B // world
    with use_mesh(mesh):
        res = _ranges_after(_mesh_convs(),
                            [x[rank * n:(rank + 1) * n] for x in _batches()])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_ranges_over_two_processes_equal_the_whole_batch(tmp_path):
    """Two gloo processes, each with half the batch (the large values
    in one half only), under a data-parallel mesh: the batch absmax
    is the maximum over both, so every process ends with the ranges
    one process computes over the whole batch (the input ranges bit
    for bit, the output ranges to the float32 rounding of the conv
    output whose maximum they are, 4e-7)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "2", str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for p in procs:
            log = p.communicate(timeout=120)[0]
            assert p.returncode == 0, log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    want = _ranges_after(_mesh_convs(), _batches())
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got.keys() == want.keys()
        for k, w in want.items():
            if k.endswith("amax_in"):
                assert torch.equal(got[k], w), (r, k)
            else:
                assert float((got[k] - w).abs().max()) <= \
                    4e-7 * float(w.max()), (r, k)
    half = _ranges_after(_mesh_convs(), [x[:B // 2] for x in
                                          _batches()])
    assert not torch.equal(half["0.amax_in"], want["0.amax_in"])


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
