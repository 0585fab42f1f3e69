"""The port stands alone: nothing under ``src/repro_torch/`` or in
``chip_smoke.py`` imports JAX or the JAX package, and the engines run on
CUDA unless the caller asks for the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import lm_params_from_numpy, lm_state_from_numpy, params_from_numpy
from repro_torch.core import ChannelGraph, Network, NetworkSim
from repro_torch.core.distributed import GraphEngine, GridEngine
from repro_torch.core.fastgrid import RegisterGridEngine
from repro_torch.core.fused import FusedEngine
from repro_torch.core.struct import tree_paths
from repro_torch.hw.manycore import CoreParams, ManycoreCell, make_core_params
from repro_torch.hw.systolic import SystolicCell, make_cell_params, make_systolic_network
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import model as lm

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py")))


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
    assert {"fused.py", "granule_step.py", "fastgrid.py", "systolic_step.py",
            "systolic.py", "chip_smoke.py", "flash_attention.py", "rglru_scan.py",
            "slstm_scan.py", "ops.py", "ref.py", "lm_checks.py", "layers.py",
            "recurrent.py", "model.py", "config.py", "registry.py",
            "recurrentgemma_2b.py", "xlstm_125m.py", "serve.py", "pipestage.py",
            "torch_wafer_scale.py", "torch_systolic_matmul.py",
            "torch_heterogeneous_soc.py", "session.py", "trace.py", "schema.py",
            "report.py", "checkpointing.py", "perfmodel.py",
            "torch_quickstart.py", "shmem.py", "worker.py", "launcher.py",
            "fault_tolerance.py", "bridge.py", "fleet.py", "telemetry.py",
            "drift.py", "optimizer.py", "grad_compression.py", "pipeline.py",
            "steps.py", "train.py", "torch_train_pipeline.py"} <= names
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/runtime/bridge.py", "src/repro_torch/runtime/fleet.py",
            "src/repro_torch/obs/telemetry.py", "src/repro_torch/obs/drift.py"} <= scanned
    assert {"obs", "checkpoint", "core", "runtime", "optim", "data"} <= {
        p.parent.name for p in PORT_FILES}
    assert {"flash_attention.cu", "rglru_scan.cu", "slstm_scan.cu"} <= {
        p.name for p in (ROOT / "src" / "repro_torch" / "kernels" / "csrc").iterdir()}
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
        lambda **kw: GraphEngine(_graph(), None, **kw),
        lambda **kw: GridEngine(SystolicCell(2), 2, 2, K=2, **kw),
        lambda **kw: NetworkSim(_graph(), **kw),
        lambda **kw: Network().build(**kw),
        lambda **kw: RegisterGridEngine(2, 2, K=2, m_stream=2, **kw),
        lambda **kw: make_systolic_network(np.ones((2, 2)), np.ones((2, 2)))[0].build(
            engine="register", K=2, **kw),
        lambda **kw: params_from_numpy(CoreParams, {"value": np.ones(4, np.float32)},
                                       **kw).value,
    ]
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        assert make(device="cpu").device.type == "cpu"


def test_procs_engine_defaults_to_cuda(monkeypatch):
    """``build(engine="procs")`` places its workers on CUDA unless told
    ``device="cpu"``; without a card the launcher raises before it lowers
    the graph or spawns anything."""
    from repro_torch.runtime import launcher

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default would spawn a fleet")
    spawned = []
    monkeypatch.setattr(launcher, "lower_partition",
                        lambda *a: spawned.append("lowered"))
    monkeypatch.setattr(launcher, "_worker_mp_context",
                        lambda: spawned.append("context"))
    net = Network(payload_words=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        net.build(engine="procs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.ProcsEngine(_graph(), None)
    assert spawned == []


def test_lm_entry_points_default_to_cuda():
    """``serve``, ``train``, ``init_params``, ``lm_params_from_numpy`` and
    ``lm_state_from_numpy`` run on CUDA unless told ``device="cpu"``; without
    CUDA the default raises."""
    cfg = get_config("xlstm-125m", smoke=True)
    arrays = {p: x.float().numpy() for p, x in tree_paths(lm.init_params(cfg, 0, "cpu"))}
    states = {p: x.float().numpy()
              for p, x in tree_paths(lm.init_decode_state(cfg, 1, 8, "cpu"))}
    makers = [
        lambda **kw: serve("xlstm-125m", smoke=True, batch=1, prompt_len=8, gen=2,
                           verbose=False, **kw)["tokens"],
        lambda **kw: train("xlstm-125m", smoke=True, steps=1, batch=1, seq=8,
                           verbose=False, **kw)["losses"],
        lambda **kw: lm.init_params(cfg, 0, **kw)["embed"],
        lambda **kw: lm_params_from_numpy(cfg, arrays, **kw)["embed"],
        lambda **kw: lm_state_from_numpy(cfg, states, **kw)[0][1]["m"],
    ]
    for make in makers:
        if torch.cuda.is_available():
            out = make()
            assert not isinstance(out, torch.Tensor) or out.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        make(device="cpu")


def test_register_engine_rejects_other_graphs():
    """``from_graph`` takes only the row-major east/south grid of one
    ``SystolicCell`` group; anything else raises ``ValueError``."""
    A, B = np.ones((3, 2), np.float32), np.ones((2, 2), np.float32)
    cell = SystolicCell(3)
    graphs = [
        _graph(),  # a ManycoreCell torus
        ChannelGraph.torus(cell, 2, 2, params=make_cell_params(A, B)),  # wrap links
        ChannelGraph.grid(cell, 2, 2),  # no params
    ]
    net, grid = make_systolic_network(A, B)
    net.external_out(grid[1][1]["s_out"])  # a host port
    graphs.append(net.graph())
    for g in graphs:
        with pytest.raises(ValueError, match="register"):
            RegisterGridEngine.from_graph(g, K=2, device="cpu")
    ok = ChannelGraph.grid(cell, 2, 2, params=make_cell_params(A, B))
    assert RegisterGridEngine.from_graph(ok, K=2, device="cpu").R == 2
