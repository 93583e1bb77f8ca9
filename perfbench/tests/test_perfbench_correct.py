"""``correct`` catches what it must: a run with a fault planted in its
timed path comes out not correct, and so does the control, the plain
reference in the configuration's lower precision put in the program's
place.

The faults run the whole of a run but the look for a card, on the CPU
at a tiny size. The control runs on the card at each cell's own size,
and skips without one."""

import pytest
import torch

from perfbench import calibrate, cells

TINY = dict(batch=2, height=64, width=128, pool=3, warmup=1)
FAULTS = [("flow_infer_b8", "altered"), ("flow_infer_b8", "half_batch"),
          ("flow_train_b32", "half_batch"), ("flow_train_b32", "unchanged")]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(name: str):
    cell = cells.load_cell(name)
    cell.params.update(TINY)
    return cell


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault):
    (r,) = calibrate.readings(tiny(name), [7], torch.device("cpu"),
                              fault=fault, seconds=0.2)
    assert r["correct"] is False, r


# The limits are set at each cell's own size; they hold at this size too,
# so the faults above fail for their fault and not for the size.
@pytest.mark.parametrize("name", ["flow_infer_b8", "flow_train_b32"])
def test_sound_run_is_correct(name):
    (r,) = calibrate.readings(tiny(name), [7], torch.device("cpu"),
                              seconds=0.2)
    assert r["correct"] is True, r


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flow_infer_b8", "flow_train_b32"])
def test_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a card")
    out = calibrate.readings(cells.load_cell(name),
                             [2147483905, 2147483906, 2147483907],
                             torch.device("cuda", 0), system="control")
    assert not any(r["correct"] for r in out), out
