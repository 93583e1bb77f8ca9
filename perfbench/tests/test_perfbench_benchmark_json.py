"""BENCHMARK.json keeps to the benchmark's format: names, units and
keys, the files it names, the metrics each cell reports, the bounds and
the check's time budget."""

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert line(e[k]), (e["name"], k)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        wl = json.loads((ROOT / "perfbench" / "workloads"
                         / f"{w['name']}.json").read_text())
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert (ROOT / "perfbench" / "traffic" / f"{wl['kind']}.py").exists()


def _reports(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_metrics_per_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (ROOT / "perfbench" / "metrics"
                / f"{m['name']}.py").exists()
        for cell in m.get("workloads", []):
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for w in BENCH["workloads"]:
        mine = [m for m in e2e.values() if _reports(m, w["name"])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(_reports(m, w["name"]) for m in BENCH["per_layer"])


def test_check_fits_its_budget():
    """A full check of 24 cells at run_seconds fits 43,200 s."""
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert math.isfinite(total)
