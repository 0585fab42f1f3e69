"""Nothing under ``bench/`` imports JAX or the JAX package, and the plain
reference imports nothing of the program either.  Modules are compared by
their top-level name whole: the port's name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FILES = sorted(BENCH.rglob("*.py"))
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def _imports(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append("." * node.level + (node.module or ""))
    return out


def _top(module: str) -> str:
    return module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    bad = [m for m in _imports(path) if _top(m) in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "torch", "numpy", "math"}
    bad = [m for m in _imports(path) if _top(m) not in allowed]
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_sees_the_benchmark():
    names = {p.name for p in FILES}
    assert {"run.py", "harness.py", "wafer_ref.py", "systolic_ref.py", "wafer.py",
            "systolic.py"} <= names
    assert len(REFERENCE) >= 2
