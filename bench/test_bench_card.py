"""The harness on the card at small sizes: every cell's whole run, traced
and untraced, comes out correct with every metric of its kind.  Needs a
CUDA card; skips without one (``python3 -m pytest -q -m cuda bench/``)."""
import json
from pathlib import Path

import pytest
import torch

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
SMALL = {
    "wafer": dict(grid_rows=32, grid_cols=32, k_inner=4, k_outer=2, queue_capacity=8,
                  max_epochs=100),
    "systolic": dict(grid_rows=33, grid_cols=18, m_stream=24, k=5, max_epochs=100),
}
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_on_the_card_is_correct(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.benchmark()
    _, cfg, _ = harness.cell_files(bench, cell)
    cfg = dict(cfg, **SMALL[cfg["system"]])
    result, _ = harness.run_cell(cell, 2**31 + 3, 0.5, trace, device="cuda", bench=bench, cfg=cfg)
    assert result["correct"], result["checks"]
    want = {m["name"] for m in harness.metrics_of(bench, cell, trace)}
    assert set(result["metrics"]) == want, json.dumps(result)[:2000]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["metrics"]["cycle_roofline"]["value"] < 105
