"""The harness takes a system as data: a system module that simulates no
cycles, has no byte count and holds its answer to a tolerance runs
through ``run_cell`` without an edit to the harness, its limits read from
its configuration; the metrics it has nothing for are left out."""
import types

import pytest

from bench import harness


def _toy(answer: float):
    class System:
        cores = 1

        def __init__(self, cfg, mix, seed, device):
            self.runs = 0

        def reset(self, run):
            self.runs += 1

        def run(self):
            pass

        def readback(self):
            return answer

        def close(self):
            pass

    class Check:
        def __init__(self, cfg, mix, seed, device):
            pass

        def __call__(self, run, out, rec):
            return {"abs_err": abs(out - 1.0)}

    return types.SimpleNamespace(System=System, Check=Check)


@pytest.mark.parametrize("answer, correct", [(1.0 + 1e-4, True), (1.01, False)])
@pytest.mark.parametrize("trace", [False, True])
def test_a_system_without_cycles_or_bytes_runs_with_its_own_limits(
        monkeypatch, answer, correct, trace):
    bench = harness.benchmark()
    workload = bench["workloads"][0]["name"]
    cfg = {"system": "toy", "limits": {"abs_err": 1e-3}}
    monkeypatch.setattr(harness, "system_module", lambda c: _toy(answer))
    result, checks = harness.run_cell(workload, 3, 0.02, trace, device="cpu", bench=bench,
                                      cfg=cfg)
    assert result["correct"] is correct and result["attempted"] >= 1
    assert checks == [("abs_err", pytest.approx(abs(answer - 1.0)), 1e-3)]
    assert "core_cycles_per_s" not in result["metrics"]
    assert "cycle_roofline" not in result["metrics"]
    assert list(result)[-1] == "checks"
