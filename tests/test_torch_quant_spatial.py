"""The int8 flow net on the H-sharded path (the local transport: the
shards folded into the batch) against the port's unsharded int8 model and
against the JAX package's int8 model, on CPU.

The seeded Flax tree (small flow heads) takes its activation ranges from
a QAT train-mode forward of the port; the same tree goes into every
model. The checks:

  * each conv, by tests/test_torch_quant_model.py's method: every
    quantized conv of JAX's int8 forward is recorded (input, ranges,
    output) and the port's conv is run on JAX's input from JAX's
    ranges, once whole and once split in
    n = 2 and 4 H shards under the mesh. The sharded run's int32
    accumulations and its outputs (QTensor codes, or floats) equal the
    whole run's exactly; the whole run is held to JAX's outputs with
    tests/test_torch_quant_model.py's bound on flipped codes;
  * the flow end to end: sharded against unsharded (the same int8
    products; the window warp, the haloed cost volume and the 2x
    upsampling compute each row as the whole map does, so float32 to
    1e-6 of the magnitude), and against JAX's int8 model, which XLA
    partitions over 2 H shards of the CPU's host devices exactly as its
    unsharded self (1e-5, relative L2). End to end the port and JAX
    differ where a code flipped at a rounding boundary (the teacher-forced
    check bounds those: at most 0.25% of a conv's outputs here), and the
    decoder's upsampling spreads a flipped flow code over its
    neighbourhood: relative L2 within FLIP_L2 (measured 0.0206 at this
    input, 40% of the pixels moved, by at most 0.19 px of a mean |flow|
    of 1.69).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpwcnet_torch.models import build_flow_net, load_flax_variables
from qpwcnet_torch.models.from_flax import to_flax_quant_stats, torch_key
from qpwcnet_torch.parallel import (
    SpatialConfig,
    make_mesh,
    make_spatial_forward,
    shard_batch_spatial,
    unshard_batch_spatial,
)
from qpwcnet_torch.parallel.transport import use_mesh
from qpwcnet_torch.quantize import QTensor, QuantConfig
from qpwcnet_torch.quantize import int8 as port_int8
from qpwcnet_tpu.models.pwcnet import PWCFlowNet as JPWCFlowNet
from qpwcnet_tpu.parallel import make_mesh as j_make_mesh
from qpwcnet_tpu.parallel.spatial import (
    make_spatial_forward as j_spatial_forward,
)
from qpwcnet_tpu.parallel.spatial import (
    shard_batch_spatial as j_shard_batch,
)
from qpwcnet_tpu.parallel.spatial_ops import SpatialConfig as JSpatialConfig
from qpwcnet_tpu.quantize import QuantConfig as JQuantConfig
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_quant_model import (
    _capture,
    _rel,
    _set_ranges,
    _t,
    _teacher_forced,
    _variables,
)

# H splits 4 ways and keeps whole rows down the 5-stage pyramid
H, W, B = 128, 64, 2
QAT, INT8 = QuantConfig(), QuantConfig(mode="int8")
WARP_HALO = 16
# the flow's relative L2 distance from JAX's that flipped codes may make
# (module docstring)
FLIP_L2 = 0.05


def _inputs(seed):
    return np.random.RandomState(seed).uniform(
        -0.5, 0.5, (B, H, W, 6)).astype(np.float32)


@pytest.fixture(scope="module")
def setup(flow_setup):
    """(the seeded tree with the ranges of a port QAT train-mode forward,
    the input, JAX's int8 output and its recorded convs)."""
    _, variables = flow_setup
    qat = build_flow_net(0, "cpu", quant=QAT)
    v = _variables(variables, qat, seed=20)
    qat.train()
    with torch.no_grad():
        qat(torch.from_numpy(_inputs(21)))
    v = {"params": v["params"], "batch_stats": v["batch_stats"],
         "quant_stats": to_flax_quant_stats(qat)}
    x = _inputs(22)
    want, _, records = _capture(
        JPWCFlowNet(cv_impl="xla", quant=JQuantConfig(mode="int8")), v, x,
        train=False)
    assert len(records) == 69
    return v, x, np.asarray(want), records


def _int8_model(v, spatial=None):
    return load_flax_variables(
        build_flow_net(0, "cpu", quant=INT8, spatial=spatial), v)


class _Int32Log:
    """Records every int32 accumulation of the int8 convs."""

    def __init__(self):
        self.out = []

    def __enter__(self):
        self.saved = port_int8.int8_conv_int32

        def logged(*a, **kw):
            y = self.saved(*a, **kw)
            self.out.append(y)
            return y

        port_int8.int8_conv_int32 = logged
        return self

    def __exit__(self, *exc):
        port_int8.int8_conv_int32 = self.saved


def _shard(t, mesh):
    """A logical NCHW tensor (or QTensor) split into the mesh's H shards,
    folded into the batch."""
    if isinstance(t, QTensor):
        return QTensor(mesh.model.keep(t.q, 2), t.scale)
    return mesh.model.keep(t, 2)


def _whole(t, mesh, dim=2):
    if isinstance(t, QTensor):
        return QTensor(mesh.model.gather(t.q, dim), t.scale)
    return mesh.model.gather(t, dim)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_int8_convs_equal_the_whole(setup, n):
    """Every conv of the int8 forward on JAX's recorded input and ranges:
    split in n H shards (SAME padding of the whole image, the halo rows
    exchanged as int8 codes, the transposes' one-row halo), its int32
    accumulations and outputs equal the whole conv's exactly; the whole
    convs against JAX's outputs by the teacher-forced bound of
    tests/test_torch_quant_model.py."""
    v, _, _, records = setup
    port = _int8_model(v)
    mods = dict(port.named_modules())
    mesh = make_mesh(n_data=1, n_model=n)
    kinds = set()
    for name, _, emit, x, _, after, _ in records:
        mod = mods[torch_key(tuple(name.split("/")) + ("kernel",))[
            :-len(".weight")]]
        _set_ranges(mod, after)
        xt = _t(x)
        with torch.no_grad(), _Int32Log() as whole_log:
            want = mod(xt, emit_qtensor=emit)
        with torch.no_grad(), _Int32Log() as shard_log, use_mesh(mesh):
            got = mod(_shard(xt, mesh), emit_qtensor=emit)
        got = _whole(got, mesh)
        (acc_w,), (acc_s,) = whole_log.out, shard_log.out
        assert acc_s.dtype == torch.int32
        assert torch.equal(mesh.model.gather(acc_s, 1), acc_w), name
        if isinstance(want, QTensor):
            assert torch.equal(got.q, want.q) and torch.equal(
                got.scale, want.scale), name
        else:
            assert torch.equal(got, want), name
        kinds.add((mod.TRANSPOSE, mod.groups > 1, mod.stride))
    # dense s1 and s2, depthwise and transpose convs all ran sharded
    assert {(False, False, 1), (False, False, 2), (False, True, 1),
            (True, False, 2)} <= kinds
    if n == 2:  # the whole convs once
        _teacher_forced(port, records)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_int8_forward_matches_unsharded(setup, n):
    """The int8 model under make_spatial_forward against the unsharded
    int8 model: float32 to 1e-6 of the flow's magnitude; and against
    JAX's int8 output within FLIP_L2 (module docstring)."""
    v, x, want_j, _ = setup
    mesh = make_mesh(n_data=1, n_model=n)
    fwd = make_spatial_forward(lambda m, ims: m(ims), mesh)
    sp = _int8_model(v, SpatialConfig(mesh, warp_halo=WARP_HALO))
    with torch.no_grad():
        want = _int8_model(v)(torch.from_numpy(x))
        got = unshard_batch_spatial(fwd(sp, shard_batch_spatial(x, mesh)),
                                    mesh)
    assert float(want.abs().mean()) > 0.2
    err = float((got - want).abs().max())
    assert err <= 1e-6 * max(1.0, float(want.abs().max())), err
    assert _rel(got.numpy(), want_j) <= FLIP_L2, _rel(got.numpy(), want_j)


def test_jax_sharded_int8_forward_matches_its_unsharded(setup):
    """JAX's int8 model partitioned by XLA over 2 H shards of the host
    devices: its flow equals its unsharded flow (1e-5 relative L2), the
    reference the port's sharded int8 forward is held to above."""
    v, x, want_j, _ = setup
    mesh = j_make_mesh(n_data=1, n_model=2)
    jm = JPWCFlowNet(cv_impl="xla", quant=JQuantConfig(mode="int8"),
                     spatial=JSpatialConfig(mesh=mesh, cv_impl="xla",
                                            warp_halo=WARP_HALO))
    fwd = j_spatial_forward(lambda v, ims: jm.apply(v, ims, train=False),
                            mesh)
    got = np.asarray(jax.device_get(fwd(v, j_shard_batch(jnp.asarray(x),
                                                         mesh))))
    assert _rel(got, want_j) <= 1e-5, _rel(got, want_j)
