"""A configuration, a traffic kind, a cell and a per-layer metric are
added with new files and new BENCHMARK.json entries alone: in a copy of
the benchmark, the harness finds each by name and runs the new cell."""

import json
import shutil
from pathlib import Path

import torch

from perfbench import cells, readers, run
from perfbench.loop import Window
from perfbench.trace import Spans

ROOT = Path(__file__).resolve().parents[2]

KIND = '''"""One batch in flight: the closed loop with no overlap."""
from pathlib import Path

from perfbench import cells

base = cells.load_module(Path(__file__).parent / "infer_closed_loop.py")


class Runner(base.Runner):
    def __init__(self, cell, seed, device, system="program"):
        cell.params["in_flight"] = 1
        super().__init__(cell, seed, device, system)
'''

METRIC = '''"""window_units: batches the window completed."""


def read(ctx):
    return float(ctx.window.units)
'''


def test_new_files_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / "perfbench"

    cfg = json.loads((base / "configs" / "pwcnet_flow.json").read_text())
    cfg["name"] = "pwcnet_flow_copy"
    (base / "configs" / "pwcnet_flow_copy.json").write_text(json.dumps(cfg))
    (base / "traffic" / "infer_serial.py").write_text(KIND)
    (base / "metrics" / "window_units.py").write_text(METRIC)
    wl = json.loads((base / "workloads" / "flow_infer_b8.json").read_text())
    wl.update(config="pwcnet_flow_copy", traffic="infer_64x128_b2_serial",
              kind="infer_serial")
    wl["params"].update(batch=2, height=64, width=128, pool=2, warmup=1)
    (base / "workloads" / "tiny_serial.json").write_text(json.dumps(wl))

    bench["configs"].append({"name": "pwcnet_flow_copy", "source": "s",
                             "file": "perfbench/configs/"
                                     "pwcnet_flow_copy.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "tiny_serial",
                               "config": "pwcnet_flow_copy",
                               "traffic": "infer_64x128_b2_serial",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("pairs_per_s", "infer_p95_ms"):
            m["workloads"].append("tiny_serial")
    bench["per_layer"].append({"name": "window_units", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "host dispatch",
                               "moves": "pairs_per_s",
                               "workloads": ["tiny_serial"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load_cell("tiny_serial", root=tmp_path)
    assert cell.config["name"] == "pwcnet_flow_copy"
    assert Path(cell.kind.__file__).parent == base / "traffic"
    assert [m["name"] for m in cell.per_layer] == ["window_units"]
    assert {m["name"] for m in cell.end_to_end} == {
        "pairs_per_s", "infer_p95_ms", "setup_s"}

    out = run.execute(cell, 11, 0.2, False, torch.device("cpu"),
                      t_start=0.0)
    assert set(out["metrics"]) == {"pairs_per_s", "infer_p95_ms", "setup_s"}
    assert out["attempted"] >= 1
    ctx = readers.Context(window=Window(units=3, seconds=1.0, spans=Spans()),
                          sub=None, enqueue_span="forward_enqueue",
                          flops_per_unit=1.0, bounds={})
    assert cell.reader("window_units")(ctx) == 3.0
