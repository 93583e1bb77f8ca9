"""The mesh over torch.distributed processes (gloo on CPU) against the
local transport: the H-sharded forward and train step on model 2 and on
data 2 x model 2 processes equal the local mesh's (all shards in one
process), a data-parallel step over 2 processes equals the unsharded
step, BatchNorm statistics included, and the int8 model's sharded forward
over 2 processes (int8 halo rows) equals the local mesh's.

Each case spawns this file as a script, one process a rank (``python
tests/test_torch_spatial_mp.py CASE RANK WORLD PORT OUT``): it imports
torch and the port only, never JAX. Every process has a time limit and
all are killed when one fails; the process group has a timeout too.

Tolerances: the forward 1e-6 (the same ops on the same rows; float32);
the loss, epe and BatchNorm running statistics 1e-5 (the batch sums
all-reduced in another order); each gradient 1e-4 of its leaf's max|g|
(for the two leaves whose gradient is a near-total cancellation before
a train-mode BatchNorm, of the largest in their flow head); the
parameters after one Adam step 1e-3 of the learning rate plus the
float32 rounding and what the gradient tolerance moves the step by
(its slope lr·eps/(|g| + eps)², steep where |g| is near eps) where |g|
exceeds the gradient tolerance, else the 2 lr an Adam step can differ by
when the sign of g is not determined (tests/test_torch_train.py's
rule).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ != "__main__":
    import pytest

    from tests.test_torch_model import one_torch_thread  # noqa: F401

H, W, B = 64, 64, 2
LR = 1e-4
ADAM_EPS = 1e-8
# (n_data, n_model) of each case's mesh; "partial" asks for a mesh of one
# process in a world of two
CASES = {"model2": (1, 2), "data2_model2": (2, 2), "data2": (2, 1),
         "partial": (2, 1), "int8_model2": (1, 2)}
CANCELLING = ("conv1x1.bias", "of_feats.3.pointwise.bias")


def _setup():
    """The batch and the flow heads' weights every process and the
    reference build alike."""
    rng = np.random.RandomState(11)
    batch = {"ims": torch.from_numpy(
        rng.uniform(-0.5, 0.5, (B, H, W, 6)).astype(np.float32)),
        "flo": torch.from_numpy(
            rng.uniform(-2.0, 2.0, (B, H, W, 2)).astype(np.float32))}
    gen = torch.Generator().manual_seed(5)
    heads = []
    for _ in range(5):
        heads.append(torch.randn((2, 16, 3, 3), generator=gen) * 3.0)
    return batch, heads


def _model(spatial=None):
    from qpwcnet_torch.models import build_flow_net

    model = build_flow_net(0, "cpu", head_scale="unit", residual=True,
                           spatial=spatial)
    _, heads = _setup()
    with torch.no_grad():
        for blk, w in zip([model.flower.flow_0, *model.flower.upflows],
                          heads):
            blk.flow.of_flow.weight.copy_(w)
    return model


def _run(mesh, spatial: bool) -> dict:
    """The forward (eval) and one train step on ``mesh``: the whole
    forward output, the step's metrics, state and gradients."""
    from qpwcnet_torch.parallel import (
        SpatialConfig,
        make_parallel_step,
        make_spatial_forward,
        make_spatial_train_step,
        put_batch,
        replicate,
        shard_batch,
        shard_batch_spatial,
        unshard_batch_spatial,
    )
    from qpwcnet_torch.train import default_optimizer, make_flow_train_step

    batch, _ = _setup()
    out = {}
    if spatial:
        model = _model(SpatialConfig(mesh, warp_halo=8))
        fwd = make_spatial_forward(lambda m, x: m(x), mesh)
        with torch.no_grad():
            out["flow"] = unshard_batch_spatial(
                fwd(model, shard_batch_spatial(batch["ims"], mesh)), mesh)
        step = make_spatial_train_step(make_flow_train_step(), mesh)
        local = {k: shard_batch_spatial(v, mesh) for k, v in batch.items()}
    else:
        model = _model()
        step = make_parallel_step(make_flow_train_step(), mesh)
        # each process's own slice, as a per-process loader gives it
        local = put_batch(shard_batch(batch, mesh), mesh)
    replicate(model, mesh)
    metrics = step(model, default_optimizer(model, LR), local)
    out.update({k: float(v) for k, v in metrics.items()})
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    return out


def _int8_flow(mesh) -> torch.Tensor:
    """The int8 model's H-sharded forward on ``mesh`` (its convs exchange
    their halo rows as int8 codes): :func:`_model`'s weights, and the
    ranges from a QAT train-mode forward of the unsharded model on the
    whole batch, which every process computes alike."""
    import dataclasses

    from qpwcnet_torch.models import build_flow_net
    from qpwcnet_torch.parallel import (
        SpatialConfig,
        make_spatial_forward,
        shard_batch_spatial,
        unshard_batch_spatial,
    )
    from qpwcnet_torch.quantize import QuantConfig

    batch, heads = _setup()
    quant = {"qat": QuantConfig(), "int8": dataclasses.replace(
        QuantConfig(), mode="int8")}
    models = {}
    for mode, q in quant.items():
        models[mode] = build_flow_net(
            0, "cpu", head_scale="unit", residual=True, quant=q,
            spatial=SpatialConfig(mesh, warp_halo=8) if mode == "int8"
            else None)
        with torch.no_grad():
            for blk, w in zip([models[mode].flower.flow_0,
                               *models[mode].flower.upflows], heads):
                blk.flow.of_flow.weight.copy_(w)
    with torch.no_grad():
        models["qat"].train()(batch["ims"])
    model = models["int8"]
    model.load_state_dict({k: v for k, v in models["qat"].state_dict()
                           .items() if "amax" in k}, strict=False)
    fwd = make_spatial_forward(lambda m, x: m(x), mesh)
    with torch.no_grad():
        return unshard_batch_spatial(
            fwd(model, shard_batch_spatial(batch["ims"], mesh)), mesh)


def _child(case: str, rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from qpwcnet_torch.parallel import (
        initialize_distributed,
        is_primary,
        make_mesh,
    )

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo",
                           timeout_s=60.0)
    assert is_primary() == (rank == 0)
    n_data, n_model = CASES[case]
    if case == "partial":
        try:
            make_mesh(n_data=1, n_model=1)
            res = {"refused": ""}
        except ValueError as e:
            res = {"refused": str(e)}
    elif case == "int8_model2":
        res = {"flow": _int8_flow(make_mesh(n_data=n_data,
                                            n_model=n_model))}
    else:
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        res = _run(mesh, spatial=n_model > 1)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(case: str, tmp_path, timeout_s: float = 150.0) -> list:
    n_data, n_model = CASES[case]
    world = n_data * n_model
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
            if p.returncode != 0:
                raise AssertionError(f"{case}: a rank failed:\n{logs[-1]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def _grad_tol(name, grads, noise) -> float:
    """1e-4 of the leaf's max|g|; for a cancelling leaf, of the largest
    in its flow head, plus four times ``noise[name]``: that leaf's
    difference between two equivalent computations of the same step in
    one process (the local mesh's and the unsharded), its rounding noise,
    relative to the cancelled terms (at the coarsest level BatchNorm
    normalizes 8 pixels)."""
    if name.endswith(CANCELLING):
        head = name.split(".flow.")[0]
        return 1e-4 * max(float(g.abs().max()) for k, g in grads.items()
                          if k.startswith(head + ".flow.")) \
            + 4.0 * noise[name]
    return 1e-4 * float(grads[name].abs().max())


def _check(got: dict, want: dict, noise: dict) -> None:
    for k in ("loss", "epe"):
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
    for k, g in want["grads"].items():
        dg = _grad_tol(k, want["grads"], noise)
        err = float((got["grads"][k] - g).abs().max())
        assert err <= dg or err == 0.0, (k, err, dg)
    params = dict(want["grads"])
    for k, w in want["state"].items():
        err = (got["state"][k] - w).abs()
        if k not in params:  # BatchNorm running statistics
            assert float(err.max()) <= 1e-5, k
            continue
        dg = _grad_tol(k, want["grads"], noise)
        slope = LR * ADAM_EPS / (params[k].abs() + ADAM_EPS) ** 2
        tol = 1e-3 * LR + 2.0 ** -22 * w.abs() + slope * dg
        assert not bool(((err > tol) & (params[k].abs() > dg)).any()), k
        assert float(err.max()) <= 2.0 * LR * (1 + 1e-3), k


def _same_on_every_rank(results: list) -> None:
    first = results[0]
    for res in results[1:]:
        for k, v in first["state"].items():
            assert torch.equal(res["state"][k], v), k
        assert res["loss"] == first["loss"]


def _unsharded() -> dict:
    """One train step of the unsharded model on the whole batch."""
    from qpwcnet_torch.train import default_optimizer, make_flow_train_step

    batch, _ = _setup()
    model = _model()
    metrics = make_flow_train_step()(model, default_optimizer(model, LR),
                                     batch)
    out = {k: float(v) for k, v in metrics.items()}
    out["state"] = model.state_dict()
    out["grads"] = {k: p.grad for k, p in model.named_parameters()}
    return out


if __name__ != "__main__":

    @pytest.fixture(scope="module")
    def refs():
        """The local mesh's run (model 2, in this process), the unsharded
        step, and each leaf's difference between their gradients."""
        from qpwcnet_torch.parallel import make_mesh

        torch.set_num_threads(1)
        local = _run(make_mesh(n_data=1, n_model=2), spatial=True)
        plain = _unsharded()
        noise = {k: float((local["grads"][k] - g).abs().max())
                 for k, g in plain["grads"].items()}
        return local, plain, noise

    @pytest.mark.parametrize("case", ["model2", "data2_model2"])
    def test_process_group_spatial_path_matches_local(case, refs, tmp_path):
        """The H-sharded forward and one train step over gloo processes
        (each holding one H shard of one data slice) equal the local
        transport's, and every process ends with the same state."""
        want, _, noise = refs
        results = _spawn(case, tmp_path)
        _same_on_every_rank(results)
        got = results[0]
        err = float((got["flow"] - want["flow"]).abs().max())
        assert err <= 1e-6 * max(1.0, float(want["flow"].abs().max())), err
        assert float(want["flow"].abs().max()) > 0.1
        _check(got, want, noise)

    def test_data_parallel_step_matches_unsharded(refs, tmp_path):
        """make_parallel_step over 2 gloo processes (a batch slice each)
        equals the unsharded step on the whole batch: the loss, every
        gradient, the parameters and the BatchNorm statistics."""
        _, want, noise = refs
        results = _spawn("data2", tmp_path)
        _same_on_every_rank(results)
        _check(results[0], want, noise)

    def test_process_group_int8_forward_matches_local(tmp_path):
        """The int8 model's H-sharded forward over 2 gloo processes, its
        convs' halo rows sent as int8 codes by batch_isend_irecv, equals
        the local transport's bit for bit (the same int8 products and the
        same float ops on the same rows)."""
        from qpwcnet_torch.parallel import make_mesh

        want = _int8_flow(make_mesh(n_data=1, n_model=2))
        results = _spawn("int8_model2", tmp_path)
        assert float(want.abs().max()) > 0.1
        for res in results:
            assert torch.equal(res["flow"], want)

    def test_process_group_mesh_refuses_a_partial_world(tmp_path):
        """A mesh across processes must span every process: each runs
        the step."""
        for res in _spawn("partial", tmp_path):
            assert "world size 2" in res["refused"]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           int(sys.argv[4]), sys.argv[5])
