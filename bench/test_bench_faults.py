"""A whole run of the harness on the CPU at a small size, with the timed path
broken underneath, must come out not ``correct``: a run that leaves the
state as it was, an exchange between granules left out, half the batch of
granules left out, an answer altered where it is produced.  So must the
control, the reference in bfloat16 in the program's place.  A sound run
comes out ``correct``.  (The chip's look for a card is skipped: the
harness runs on ``device="cpu"``.)"""
import json
from pathlib import Path

import numpy as np
import pytest

from bench import harness
from repro_torch.core.distributed import GraphEngine
from repro_torch.core.fastgrid import RegisterGridEngine
from repro_torch.core.fused import FusedEngine
from repro_torch.kernels import fused_checks

ROOT = Path(__file__).resolve().parents[1]
SMALL = {
    "wafer-1M": dict(grid_rows=8, grid_cols=8, k_inner=4, k_outer=2, queue_capacity=8,
                     max_epochs=40),
    "systolic-1M": dict(grid_rows=6, grid_cols=5, m_stream=7, k=4, max_epochs=40),
}
SEED = 2**31 + 11


def _small(config: str) -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" / f"{config}.json").read_text())
    return dict(cfg, **SMALL[config])


def _run(cell: str) -> dict:
    result, checks = harness.run_cell(cell, SEED, 0.05, False, device="cpu",
                                      cfg=_small(cell.split(".")[0]))
    assert [k for k, _, _ in checks][-2:] == ["stop_cycle_diff", "start_cycle"]
    return result


def _unchanged(self, state, *a, **k):
    return state


def _drop_half_batch(orig):
    def init(self, key, group_params):
        states = orig(self, key, group_params)
        st = states[0]
        for leaf in ("value", "own", "acc"):
            getattr(st, leaf)[1] = 0.0  # the second pod's granules
        return states
    return init


def _alter_total(orig):
    def gather(self, state, gi):
        out = orig(self, state, gi)
        out.total[5] += 1.0
        return out
    return gather


def _alter_y(orig):
    def result(*a, **k):
        y = orig(*a, **k)
        y[0, 0] = np.nextafter(y[0, 0], np.float32(np.inf))
        return y
    return result


FAULTS = {
    "wafer-1M.fused": {
        "unchanged": lambda m: m.setattr(FusedEngine, "run_until", _unchanged),
        "exchange": lambda m: m.setattr(FusedEngine, "_resident_exchange_commit",
                                        lambda self, carry, *a, **k: carry),
        "half_batch": lambda m: m.setattr(GraphEngine, "_init_block_states",
                                          _drop_half_batch(GraphEngine._init_block_states)),
        "answer": lambda m: m.setattr(GraphEngine, "gather_group",
                                      _alter_total(GraphEngine.gather_group)),
    },
    "wafer-1M.graph": {
        "unchanged": lambda m: m.setattr(GraphEngine, "run_until", _unchanged),
        "exchange": lambda m: m.setattr(GraphEngine, "_exchange_commit",
                                        lambda self, sts, *a, **k: sts),
        "half_batch": lambda m: m.setattr(GraphEngine, "_init_block_states",
                                          _drop_half_batch(GraphEngine._init_block_states)),
        "answer": lambda m: m.setattr(GraphEngine, "gather_group",
                                      _alter_total(GraphEngine.gather_group)),
    },
    "systolic-1M.register": {
        "unchanged": lambda m: m.setattr(RegisterGridEngine, "run_until", _unchanged),
        "answer": lambda m: m.setattr(RegisterGridEngine, "result",
                                      _alter_y(RegisterGridEngine.result)),
    },
    "systolic-1M.fused": {
        "unchanged": lambda m: m.setattr(FusedEngine, "run_until", _unchanged),
        "answer": lambda m: m.setattr(fused_checks, "grid_result",
                                      _alter_y(fused_checks.grid_result)),
    },
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", [(c, f) for c in sorted(FAULTS) for f in FAULTS[c]])
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]
    assert res["failed"] == res["attempted"] >= 1


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_control_is_not_correct(cell):
    config = cell.split(".")[0]
    cfg = dict(_small(config), grid_rows=64, grid_cols=64) if config == "wafer-1M" else _small(config)
    failed, checks = harness.control(cell, SEED, device="cpu", cfg=cfg)
    assert failed == 1, checks
    assert any(value > limit for _, value, limit in checks)


def test_a_check_without_its_limits_is_refused():
    def check(run, out, rec):
        return {"total_mismatch": 0.0}

    with pytest.raises(ValueError):
        harness.judge(check, {"total_mismatch": 0.0, "start_cycle": 0.0}, [{}], [None])
