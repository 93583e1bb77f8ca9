"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. Everything else is found by name under ``perfbench/``:

  * ``workloads/<cell>.json``: the cell's configuration, traffic mix,
    traffic kind, the kind's parameters and the limits of ``correct``;
  * ``configs/<config>.json``: the configuration's sizes and how the
    program is built;
  * ``traffic/<kind>.py``: the general generator of that kind of
    traffic, which drives the system (a ``Runner`` class);
  * ``metrics/<metric>.py``: the reader of one per-layer metric (a
    ``read(ctx)`` function returning a number, or None where it finds
    nothing to read).

So a configuration, a cell or a per-layer metric is added with new
files and new entries of BENCHMARK.json alone.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file (metric names hold dots, so they are not
    importable by name)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    kind: object          # the traffic kind's module
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path

    @property
    def params(self) -> dict:
        return self.workload["params"]

    def reader(self, metric: str):
        return load_module(self.root / "perfbench" / "metrics"
                           / f"{metric}.py").read


def load_config(name: str, root: Path = ROOT) -> dict:
    """``perfbench/configs/<name>.json``."""
    return _json(root / "perfbench" / "configs" / f"{name}.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    base = root / "perfbench"
    workload = _json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: BENCHMARK.json's {key} "
                             f"{entry[key]!r} is not the workload file's "
                             f"{workload[key]!r}")
    config = load_config(entry["config"], root)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    kind = load_module(base / "traffic" / f"{workload['kind']}.py")
    return Cell(name=name, chips=entry["chips"], config=config,
                workload=workload, kind=kind, end_to_end=e2e,
                per_layer=per_layer, root=root)
