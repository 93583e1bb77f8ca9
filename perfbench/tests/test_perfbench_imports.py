"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the measured package: top-level names
(before the first dot) compared whole."""

import ast
from pathlib import Path

import pytest

BASE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "qpwcnet_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BASE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BASE)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


REF = sorted((BASE / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REF,
                         ids=[str(p.relative_to(BASE)) for p in REF])
def test_reference_stands_alone(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"qpwcnet_torch"})


def test_scan_sees_whole_names(tmp_path):
    """The port's name begins with the JAX package's: compared whole, it
    is not the JAX package."""
    f = tmp_path / "m.py"
    f.write_text("import qpwcnet_torch.models\nfrom jax import numpy\n")
    assert top_level_imports(f) & FORBIDDEN == {"jax"}
