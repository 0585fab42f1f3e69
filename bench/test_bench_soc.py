"""The soc-1M cell on the CPU at a small size (64 SoCs on 2 granules): a
whole run of the harness is correct with the cell's metrics, traced and
not; with the timed path broken underneath it is not, in every run (the
run leaves the state as it was, the DRAM contents never reach the blocks,
a result word is altered where it is read back: the digest of the words
read to the host catches each); the digest's arithmetic;
the control, the reference's results in bfloat16, is not correct; the
byte count is hand arithmetic; the new metric reads ``granule_cycle``'s
time per cycle of a trace; and ``bench/conftest.py`` gives
``test_bench_card.py`` the system's small size.  A small run on the card
is marked ``cuda``."""
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness
from bench.systems import soc
from repro_torch.core.distributed import GraphEngine
from repro_torch.core.fused import FusedEngine
from repro_torch.hw.soc import DramModel

ROOT = Path(__file__).resolve().parents[1]
CELL = "soc-1M.fused"
SEED = 2**31 + 17


def _small(**kw) -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" / "soc-1M.json").read_text())
    return dict(cfg, **{"n_socs": 64, "granules": 2, **kw})


def _run(trace=False, seconds=0.3, device="cpu", **kw) -> dict:
    result, checks = harness.run_cell(CELL, SEED, seconds, trace, device=device,
                                      cfg=_small(**kw))
    assert [k for k, _, _ in checks] == ["result_mismatch", "stop_cycle_diff", "start_cycle"]
    return result


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    res = _run(trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 1
    assert all(c["value"] == 0 for c in res["checks"].values())
    want = {m["name"] for m in harness.metrics_of(harness.benchmark(), CELL, trace)}
    got = set(res["metrics"])
    if trace:  # the CPU has no device trace to read
        assert got <= want and "reset_ms" in got
    else:
        assert got == want == {"core_cycles_per_s", "setup_s"}


def _alter_results(orig):
    def gather(self, state, gi):
        out = orig(self, state, gi)
        out.results[5, 3] = np.nextafter(out.results[5, 3], np.float32(np.inf))
        return out
    return gather


def _default_contents(orig):
    def init_state(self, n, params=None, **kw):
        return orig(self, n, None, **kw)
    return init_state


FAULTS = {
    "unchanged": lambda m: m.setattr(FusedEngine, "run_until",
                                     lambda self, state, *a, **k: state),
    "contents": lambda m: m.setattr(DramModel, "init_state",
                                    _default_contents(DramModel.init_state)),
    "answer": lambda m: m.setattr(GraphEngine, "gather_group",
                                  _alter_results(GraphEngine.gather_group)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["failed"] == res["attempted"]


def test_the_digest_catches_one_word():
    """One word one ulp off in a run's words: where they are not kept (every
    run but the first) the digest alone decides and reads every word as
    differing; where they are kept the words are counted."""
    cfg = _small()
    check = soc.Check(cfg, {"intra_channel": "register"}, SEED, "cpu")
    w = soc.weights(cfg, SEED, "cpu")
    rec = {"cycles": check.stop, "start_cycle": 0}
    for run in (0, 1):
        good = soc.soc_ref.results(soc.contents(cfg, SEED, run, "cpu"), check.addr,
                                   check.sample)
        bad = good.clone()
        bad[7, 1] = torch.nextafter(bad[7, 1], torch.tensor(0.0))
        assert check(run, soc.answer(run, good, w), rec)["result_mismatch"] == 0
        out = soc.answer(run, bad, w)
        assert (out["words"] is None) == (run != 0)
        assert check(run, out, rec)["result_mismatch"] == (1 if run == 0 else 64 * 8)


@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_the_digest_is_the_weighted_sum_modulo_2_32(n):
    """The card's int64 arithmetic against Python's integers: every word's
    bits times its weight, summed, modulo 2**32."""
    g = torch.Generator().manual_seed(n)
    words = torch.randint(0, 1024, (n,), generator=g).float() - 0.0625 * (n % 7)
    w = torch.randint(0, 2**30, (n,), generator=g, dtype=torch.int64) * 2 + 1
    bits = words.numpy().view(np.uint32).tolist()
    want = sum(b * int(x) for b, x in zip(bits, w.tolist())) % 2**32
    assert int(soc.digest(words, w)) == want


def test_a_run_without_its_digest_is_not_correct():
    """An answer whose digest never came reads as a failed run."""
    cfg = _small()
    check = soc.Check(cfg, {"intra_channel": "register"}, SEED, "cpu")
    out = {"digest": None, "shape": (64, 8), "words": None}
    rec = {"cycles": check.stop, "start_cycle": 0}
    with pytest.raises(ValueError, match="no digest"):
        check(3, out, rec)
    failed, _ = harness.judge(check, harness.limits_of(cfg), [rec], [out])
    assert failed == 1


def test_the_card_test_gets_the_small_size():
    """``bench/conftest.py`` adds the system's ``SMALL`` to
    ``test_bench_card.py``'s table where it is missing, and leaves the
    sizes that table holds as they are."""
    from bench import conftest

    wafer = {"grid_rows": 32}
    card, other = types.ModuleType("bench.test_bench_card"), types.ModuleType("bench.other")
    card.SMALL, other.SMALL = {"wafer": wafer, "systolic": {}}, {}
    conftest.pytest_collection_modifyitems([types.SimpleNamespace(module=card),
                                            types.SimpleNamespace(module=other)])
    assert card.SMALL == {"wafer": wafer, "systolic": {}, "soc": soc.SMALL}
    assert other.SMALL == {}


def test_the_control_is_not_correct():
    failed, checks = harness.control(CELL, SEED, device="cpu", cfg=_small())
    assert failed == 1, checks
    assert dict((k, v) for k, v, _ in checks)["result_mismatch"] > 0


def test_the_count_by_hand():
    cfg = _small()
    # 56 cycles = 7 epochs of 8; per SoC 117 B read and 85 B written an epoch
    assert soc.reference_schedule(cfg, {"intra_channel": "register"}, "cpu")[2] == 56
    assert soc.run_bytes(cfg, 56) == 7 * 64 * (117 + 85)
    assert soc.run_bytes(cfg, 57) == 8 * 64 * (117 + 85)


def test_granule_cycle_us_per_cycle_reads_the_kernel_time():
    read = harness.metric_reader("granule_cycle_us_per_cycle")
    trace = {"cycles": 112, "device_ops": [
        ["void granule_cycle<56>(ProgramArgs, int, int)", 0.0056],
        ["Memcpy DtoH (Device -> Pinned)", 0.4]]}
    assert read(types.SimpleNamespace(trace=trace)) == pytest.approx(50.0)
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(types.SimpleNamespace(trace=dict(trace, cycles=None))) is None
    assert read(types.SimpleNamespace(trace=dict(trace, device_ops=trace["device_ops"][1:]))) is None


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_on_the_card_is_correct(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(trace, seconds=0.5, device="cuda", **soc.SMALL)
    assert res["correct"], res["checks"]
    want = {m["name"] for m in harness.metrics_of(harness.benchmark(), CELL, trace)}
    assert set(res["metrics"]) == want, json.dumps(res)[:2000]
    if trace:
        assert res["metrics"]["granule_cycle_us_per_cycle"]["value"] > 0
        assert 0 < res["metrics"]["cycle_roofline"]["value"] < 105
