"""The session surface on the card: an in-place ``load`` keeps the state's
addresses, so the until-loop the engine captured for it replays instead
of capturing again, and the resumed run is bit-identical to the
uninterrupted one; monitors do not move the stop point of the device
loop; a legacy shim leaves the state it returns usable.

The tests need a CUDA device and skip without one; run them there with
``python -m pytest -q -m cuda tests/test_torch_session_surface_cuda.py``.
This file imports no JAX.  Tolerance: bit-exact (every state leaf, the
stop cycle and the monitor samples).
"""
import pytest
import torch

from repro_torch.core import DonatedStateError, Simulation
from repro_torch.core.struct import tree_leaves
from repro_torch.obs.registry import REGISTRY

from test_torch_until_loop_cuda import _t_done, assert_same, port_engine, to_numpy
from test_torch_until_loop_cuda import cuda  # noqa: F401  (the fixture)

SESSION_CONFIGS = ("wafer", "grid", "register")


def _captures() -> float:
    return REGISTRY.counters().get("until.captures", 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("config", SESSION_CONFIGS)
def test_inplace_load_replays_without_capture(cuda, config, tmp_path):
    eng, _ = port_engine(config, cuda)
    done = _t_done(config)
    sim = Simulation(eng).reset(0)
    sim.run(epochs=2)
    ckpt = sim.save(str(tmp_path / "ck"))
    sim.run(until=done, max_epochs=1000)
    want, stop = to_numpy(sim.state), sim.cycle
    ptrs = [x.data_ptr() for x in tree_leaves(sim.state) if isinstance(x, torch.Tensor)]

    c0 = _captures()
    sim.load(str(tmp_path / "ck"))
    assert sim.cycle == 2 * sim.period and ckpt.endswith(f"step_{2 * sim.period:08d}")
    assert ptrs == [x.data_ptr() for x in tree_leaves(sim.state)
                    if isinstance(x, torch.Tensor)]
    sim.run(until=done, max_epochs=1000)
    assert _captures() == c0, "the in-place load captured a new span"
    assert sim.cycle == stop
    assert_same(want, to_numpy(sim.state), (config, "in place"))

    fresh = Simulation(eng).reset(0).load(str(tmp_path / "ck"))
    fresh.run(until=done, max_epochs=1000)
    assert fresh.cycle == stop
    assert_same(want, to_numpy(fresh.state), (config, "fresh"))


@pytest.mark.cuda
@pytest.mark.parametrize("config", SESSION_CONFIGS)
def test_monitor_keeps_the_device_stop(cuda, config):
    eng, _ = port_engine(config, cuda)
    done = _t_done(config)
    free = Simulation(eng).reset(0)
    free.run(until=done, max_epochs=1000)
    want = to_numpy(free.state)
    sim = Simulation(eng).reset(0)
    seen = []
    sim.add_monitor(lambda s: seen.append(s.epoch), every=3)
    sim.run(until=done, max_epochs=1000)
    assert sim.cycle == free.cycle
    assert seen == list(range(3, sim.epoch + 1, 3))
    assert_same(want, to_numpy(sim.state), config)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ("wafer", "register"))
def test_shim_on_cuda_state_leaves_result_usable(cuda, config):
    """A CUDA until-run returns its input itself: the shim does not poison
    it.  ``run_epochs`` returns another object: its input is poisoned and
    its result usable."""
    eng, st = port_engine(config, cuda)
    ref_eng, ref = port_engine(config, cuda)
    want = to_numpy(ref_eng.run_epochs(ref_eng.run_until_host(ref, _t_done(config), 3), 1))
    sim = Simulation(eng)
    with pytest.warns(DeprecationWarning):
        out = sim.run_until(st, _t_done(config), 3)
    assert out is st
    epochs = int(out.epoch.reshape(-1)[0])
    assert epochs == 3
    with pytest.warns(DeprecationWarning):
        out2 = sim.run_epochs(out, 1)
    assert out2 is not out and int(out2.epoch.reshape(-1)[0]) == epochs + 1
    with pytest.raises(DonatedStateError):
        out.epoch.reshape(-1)
    assert_same(want, to_numpy(out2), config)
