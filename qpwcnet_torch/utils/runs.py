"""Run directories (the port's copy of qpwcnet_tpu/utils/runs.py): an
auto-incrementing ``root/NNN`` with ``log/`` and ``ckpt/`` inside, and
the config snapshot ``config.json``."""

from __future__ import annotations

import json
import tempfile
from dataclasses import asdict, is_dataclass
from pathlib import Path


def default_root(name: str = "run") -> Path:
    """``<tempdir>/qpwcnet_torch/<name>``, as the infer app builds its
    output directory."""
    return Path(tempfile.gettempdir()) / "qpwcnet_torch" / name


def setup_run_dir(root=None) -> dict:
    """Create the next run dir root/NNN (root: :func:`default_root` when
    empty) with log/ and ckpt/ inside; returns {'run', 'log', 'ckpt'}."""
    root = Path(root) if root else default_root()
    root.mkdir(parents=True, exist_ok=True)
    existing = [int(p.name) for p in root.iterdir()
                if p.is_dir() and p.name.isdigit()]
    run_dir = root / f"{max(existing, default=-1) + 1:03d}"
    paths = {"run": run_dir, "log": run_dir / "log",
             "ckpt": run_dir / "ckpt"}
    for p in paths.values():
        p.mkdir(parents=True, exist_ok=True)
    return paths


def snapshot_config(run_dir, config) -> None:
    """Dump a dataclass or dict config to <run_dir>/config.json."""
    if is_dataclass(config) and not isinstance(config, type):
        config = asdict(config)
    with open(Path(run_dir) / "config.json", "w") as f:
        json.dump(config, f, indent=2, default=str)
