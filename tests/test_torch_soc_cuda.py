"""``granule_step.cu``'s device steps of the heterogeneous SoC (``Cpu``,
``DramModel``, ``AnalogRamp``: the kernel's mask 56) on the card, against
the plain version (the blocks' own steps, ``epoch_program_ref``) on a copy
on the card after every epoch, mid-run included, and a session run to
``soc_done`` against the benchmark's plain reference.

This file imports no JAX, so it runs where JAX is absent (the CPU holds
the kernel's one-pass schedule for the SoC against the plain cycle in
``tests/test_torch_granule_schedule.py``).  The tests need a CUDA device
and skip without one; run them there with
``python -m pytest -q -m cuda tests/test_torch_soc_cuda.py``.
Tolerance: bit-exact (every state leaf, every result word).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).resolve().parents[1]))  # the benchmark's reference

from bench.reference import soc_ref  # noqa: E402
from repro_torch.core import ChannelGraph, Network, Simulation  # noqa: E402
from repro_torch.core.fused import FusedEngine  # noqa: E402
from repro_torch.hw.soc import (  # noqa: E402
    N_REQ, AnalogRamp, Cpu, DramModel, DramParams, soc_done, soc_graph, soc_partition,
)
from repro_torch.kernels import fused_checks as fc  # noqa: E402
from repro_torch.kernels import granule_step  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: granule_step.cu has no CPU mode")
    return torch.device("cuda")


def _contents(n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 1024, (n, N_REQ), generator=g, device=device,
                         dtype=torch.int32).float()


def _engine(n, layout, K):
    if layout == "split":  # each type on a granule of its own: all queue rows
        part, G = np.tile(np.arange(3), n), 3
    else:
        part, G = soc_partition(n, 8), 8
    return FusedEngine(soc_graph(n, capacity=4), part, None, K=K, batch_axes={"g": G},
                       overlap=False, device="cuda")


def _done(local):
    return soc_done(local.block_states[0], local.tables.active[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,layout,K", [(4096, "whole", 8), (1000, "whole", 3),
                                        (96, "split", 2)])
def test_soc_epochs_match_plain_version(cuda, n, layout, K):
    """Every epoch through the kernel against the plain version on a copy,
    every leaf bit-exact, to the end of the run: whole SoCs a granule at
    K = 8 and at an odd K (the copy-back of the paired leaves), and one
    type a granule (boundary rows, exchanges)."""
    eng = _engine(n, layout, K)
    state = eng.init(0, group_params={1: DramParams(mem=_contents(n, n + K, cuda))})
    epochs, _ = fc.check_engine(eng, _done, 200, state=state)
    assert epochs > 1


@pytest.mark.cuda
def test_soc_session_matches_reference(cuda):
    """4096 SoCs on 8 batched granules through ``Simulation``: reset with
    new contents, ``run(until=soc_done)`` on the device loop, the CPU group
    read back; every result word and the stop cycle equal the reference's,
    twice (the second run replays the captured span)."""
    n = 4096
    eng = _engine(n, "whole", 8)
    sim = Simulation(eng)
    addr, sample, stop = soc_ref.schedule(n, n_req=N_REQ, latency=DramModel.LATENCY,
                                          period=AnalogRamp.PERIOD,
                                          divider=AnalogRamp.clock_divider, k=8,
                                          capacity=4, intra="register", max_epochs=100)
    before = granule_step.launches
    for seed in (1, 2):
        mem = _contents(n, seed, cuda)
        sim.reset(0, group_params={1: DramParams(mem=mem)})
        sim.run(until=_done, max_epochs=100)
        got = eng.gather_group(sim.state, 0).results
        want = soc_ref.results(mem.cpu(), addr, sample).numpy()
        assert sim.cycle == stop
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert granule_step.launches > before


@pytest.mark.cuda
def test_other_mix_of_soc_types_raises(cuda):
    """A program of the CPU and the DRAM without the ramp has no variant:
    ``NotImplementedError`` naming the mix, before any launch."""
    net = Network(payload_words=2, capacity=4)
    cpu, dram = net.instantiate(Cpu()), net.instantiate(DramModel())
    net.connect(cpu["dram_req"], dram["req"])
    net.connect(dram["resp"], cpu["dram_resp"])
    eng = FusedEngine(ChannelGraph.from_network(net), None, None, K=2, device="cuda")
    with pytest.raises(NotImplementedError, match="Cpu, DramModel"):
        eng.run_epochs(eng.init(0), 1)
