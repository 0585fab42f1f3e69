"""The port's single-netlist ``NetworkSim`` against ``repro``'s, cycle by
cycle: a 4x4 many-core torus, and a chain of ``Increment`` blocks driven
through its external ports.  After every cycle the whole state — queue
buffers, heads, tails, block states, push/pop counters — must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChannelGraph as JGraph
from repro.core import Block as JBlock
from repro.core import Network as JNetwork
from repro.core import NetworkSim as JSim
from repro.core.struct import pytree_dataclass
from repro.hw.manycore import ManycoreCell as JCell
from repro.hw.manycore import make_core_params as j_params
from repro_torch.core import Block as TBlock
from repro_torch.core import ChannelGraph as TGraph
from repro_torch.core import Network as TNetwork
from repro_torch.core import NetworkSim as TSim
from repro_torch.core.struct import tensor_dataclass, tree_paths
from repro_torch.hw.manycore import ManycoreCell as TCell
from repro_torch.hw.manycore import make_core_params as t_params


# --------------------------------------------- the Increment block, twice
@pytree_dataclass
class JIncState:
    count: jax.Array


class JIncrement(JBlock):
    in_ports = ("to_rtl",)
    out_ports = ("from_rtl",)
    payload_words = 2

    def init_state(self, key):
        return JIncState(count=jnp.zeros((), jnp.int32))

    def step(self, state, rx, tx_ready):
        (pay, valid) = rx["to_rtl"]
        fire = valid & tx_ready["from_rtl"]
        return (
            state.replace(count=state.count + fire.astype(jnp.int32)),
            {"to_rtl": fire},
            {"from_rtl": (pay.at[0].add(1.0), fire)},
        )


@tensor_dataclass
class TIncState:
    count: torch.Tensor


class TIncrement(TBlock):
    in_ports = ("to_rtl",)
    out_ports = ("from_rtl",)
    payload_words = 2

    def init_state(self, n, params=None, *, generator=None, device=None):
        return TIncState(count=torch.zeros((n,), dtype=torch.int32, device=device))

    def step(self, state, rx, tx_ready):
        (pay, valid) = rx["to_rtl"]
        fire = valid & tx_ready["from_rtl"]
        out = pay.clone()
        out[:, 0] += 1.0
        return (
            state.replace(count=state.count + fire.to(torch.int32)),
            {"to_rtl": fire},
            {"from_rtl": (out, fire)},
        )


def chain(net_cls, blk, n, capacity):
    net = net_cls(payload_words=2, capacity=capacity)
    insts = [net.instantiate(blk, name=f"b{i}") for i in range(n)]
    net.external_in(insts[0]["to_rtl"], "tx")
    for a, b in zip(insts, insts[1:]):
        net.connect(a["from_rtl"], b["to_rtl"])
    net.external_out(insts[-1]["from_rtl"], "rx")
    return net


def _jax_leaves(state):
    return {".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]}


def assert_same(jstate, tstate, where):
    want = _jax_leaves(jstate)
    got = {p: x.numpy() for p, x in tree_paths(tstate)}
    assert sorted(got) == sorted(want), where
    for k in want:
        assert np.array_equal(got[k], want[k]), (where, k, got[k], want[k])


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("cap", [2, 4])
def test_torus_netlist_cycle_by_cycle(cap):
    R = C = 4
    vals = np.random.RandomState(cap).randint(1, 20, size=(R, C)).astype(np.float32)
    js = JSim(JGraph.torus(JCell(R, C), R, C, params=j_params(vals), capacity=cap))
    ts = TSim(TGraph.torus(TCell(R, C), R, C, params=t_params(vals), capacity=cap),
              device="cpu")
    jst, tst = js.init(jax.random.key(0)), ts.init(0)
    step = jax.jit(js.step)
    assert_same(jst, tst, "init")
    for t in range(70):
        jst, tst = step(jst), ts.step(tst)
        assert_same(jst, tst, t)
    total = tst.block_states[0].total.numpy()
    assert (total == vals.sum()).all()  # the allreduce finished everywhere


def test_chain_host_io_cycle_by_cycle():
    """Host pushes and pops through the external ports, interleaved with
    cycles, give the same states and the same packets on both packages."""
    js = chain(JNetwork, JIncrement(), 3, 4).build(session=False)
    ts = chain(TNetwork, TIncrement(), 3, 4).build(session=False, device="cpu")
    jst, tst = js.init(jax.random.key(0)), ts.init(0)
    step = jax.jit(js.step)
    rng = np.random.RandomState(1)
    got_j, got_t = [], []
    for t in range(40):
        if t % 3 == 0:
            pays = np.stack([np.arange(1, 6) + 10 * t, np.arange(5)], 1).astype(np.float32)
            jst, jn = js.host_push_many(jst, "tx", jnp.asarray(pays))
            tst, tn = ts.host_push_many(tst, "tx", pays)
            assert int(jn) == int(tn)
        if rng.rand() < 0.4:
            jst, jp, jc = js.host_pop_many(jst, "rx", 2)
            tst, tp, tc = ts.host_pop_many(tst, "rx", 2)
            assert int(jc) == int(tc)
            got_j.extend(np.asarray(jp)[: int(jc)].tolist())
            got_t.extend(tp.numpy()[: int(tc)].tolist())
        jst, tst = step(jst), ts.step(tst)
        assert_same(jst, tst, t)
    assert got_j == got_t and len(got_t) > 0
    # every packet went through three increments
    assert all(p[0] % 10 in (4, 5, 6, 7, 8) for p in got_t)


def test_build_engine_names():
    from repro_torch.core import GraphEngine

    net = chain(TNetwork, TIncrement(), 2, 4)
    sim = net.build(engine="graph", device="cpu", partition=[0, 1], K=2,
                    batch_axes={"g": 2})
    assert isinstance(sim.engine, GraphEngine) and sim.kind == "graph"
    sim.reset(0).tx("tx").send([5.0, 0.0])
    sim.run(cycles=8)
    assert sim.cycle == 8 and sim.rx("rx").recv()[0] == 7.0
    from repro_torch.runtime import ProcsEngine

    psim = net.build(engine="procs", device="cpu", partition=[0, 1], K=2)
    try:
        assert isinstance(psim.engine, ProcsEngine) and psim.kind == "procs"
        psim.reset(0).tx("tx").send([5.0, 0.0])
        psim.run(cycles=8)
        assert psim.cycle == 8 and psim.rx("rx").recv()[0] == 7.0
    finally:
        psim.engine.close()
    assert psim.engine._closed and not psim.engine._rings
    with pytest.raises(ValueError, match="unknown engine"):
        net.build(engine="bogus", device="cpu")
    assert net.build(engine="single", device="cpu").kind == "single"
