"""The port stands alone: nothing under ``src/repro_torch/`` or in
``chip_smoke.py`` imports JAX or the JAX package, and the engines run on
CUDA unless the caller asks for the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import ChannelGraph, Network, NetworkSim
from repro_torch.core.fused import FusedEngine
from repro_torch.hw.manycore import ManycoreCell, make_core_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"fused.py", "granule_step.py", "chip_smoke.py"} <= names
    assert _forbidden("jax.numpy") and _forbidden("repro.core")
    assert not _forbidden("repro_torch.core")


def _graph():
    return ChannelGraph.torus(ManycoreCell(2, 2), 2, 2,
                              params=make_core_params(np.ones((2, 2), np.float32)))


def test_engines_default_to_cuda():
    """Without CUDA the default device raises instead of running on the CPU
    quietly; ``device="cpu"`` runs there."""
    makers = [
        lambda **kw: FusedEngine(_graph(), None, **kw),
        lambda **kw: NetworkSim(_graph(), **kw),
        lambda **kw: Network().build(**kw),
    ]
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        assert make(device="cpu").device.type == "cpu"
