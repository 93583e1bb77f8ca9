"""The frozen reference against the measured package's plain path, on the
CPU at a tiny size, in float32: the same seeded state_dict loads into
both, and both compute the same forwards and the same train step."""

import copy

import pytest
import torch

from perfbench import cells, compare, data, system as systems, weights

HW = (64, 128)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def float32_config(name: str) -> dict:
    cfg = copy.deepcopy(cells.load_config(name))
    cfg["dtype"] = "float32"
    return cfg


def made(cfg, inputs, seed=3, b=2):
    gen = torch.Generator().manual_seed(seed)
    sd = weights.make_state_dict(cfg, gen, HW)
    return sd, data.MAKERS[inputs](gen, b, *HW)


@pytest.mark.parametrize("config,inputs", [("pwcnet_flow", "pairs"),
                                           ("pwcnet_interp", "triplets")])
def test_forward(config, inputs):
    cfg = float32_config(config)
    sd, batch = made(cfg, inputs)
    cpu = torch.device("cpu")
    got = systems.build("infer", cfg, sd, cpu, "program")(batch["ims"])
    want = systems.build("infer", cfg, sd, cpu, "reference")(batch["ims"])
    assert float(want.abs().max()) > 0.1     # not a vacuous comparison
    assert compare.rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("config,inputs", [("pwcnet_flow", "pairs"),
                                           ("pwcnet_interp", "triplets")])
def test_train_step(config, inputs):
    cfg = float32_config(config)
    sd, batch = made(cfg, inputs)
    cpu = torch.device("cpu")
    sides = []
    for name in ("program", "reference"):
        s = systems.build("train", cfg, sd, cpu, name)
        loss = float(s.step(batch))
        grads = compare.norms(s.first_grads())
        change = compare.norms({k: v - sd[k] for k, v in s.state().items()})
        sides.append({"losses": [loss], "grads": grads, "change": change,
                      "l2": getattr(s, "l2_terms", [])})
    numbers, _ = compare.train_numbers(*sides)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["data_loss_gap"] < 1e-4
    assert numbers["grad_gap"] < 1e-3
    assert numbers["change_gap"] < 1e-3


def test_weights_are_seeded():
    cfg = float32_config("pwcnet_flow")
    a = weights.make_state_dict(cfg, torch.Generator().manual_seed(5), HW)
    b = weights.make_state_dict(cfg, torch.Generator().manual_seed(5), HW)
    c = weights.make_state_dict(cfg, torch.Generator().manual_seed(6), HW)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.stages.0.conv_a.weight"],
                           c["encoder.stages.0.conv_a.weight"])
    heads = [k for k in a if k.endswith("of_flow.weight")]
    assert len(heads) == 5 and all(float(a[k].abs().max()) > 0 for k in heads)
