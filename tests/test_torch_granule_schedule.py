"""The one-pass cycle of ``csrc/granule_step.cu``, emulated in plain
PyTorch on the CPU, against ``FusedEngine._cycle_body`` (the plain
version, held against the JAX engine in ``tests/test_torch_fused.py`` and
``tests/test_torch_fused_grid.py``).

The kernel runs one thread a slot of every group and no scratch between
threads: each register is committed by its producer, with the consumer's
readiness recomputed from the consumer's pre-cycle state through
``granule_step.consumer_table`` — whose flat ids name the consumer's group,
so the readiness is that group's block type's, gated by that group's
clock; each boundary queue row is committed by its one local side (an
egress row's head by its producer, an ingress row's tail by its
consumer).  ``one_pass_cycle`` below does the same with whole-tensor ops
and is held bit-exact against the plain cycle on every cycle of a run to
its end: the wafer, the systolic grid (one granule and 2x2 granules with
boundary queues), a two-group systolic network with a half-rate group,
a mixed network of both block types, and the heterogeneous SoC's three
types (a CPU of two in ports and one out port, a DRAM, a ramp with no in
port on a quarter-rate clock), whole SoCs a granule and one type a
granule with every channel across an exchange.  Tolerance is bit-exact: integer
logic over exact f32 adds and one fused multiply-add a fire.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ChannelGraph, tiered_grid_partition
from repro_torch.core.fused import FusedEngine
from repro_torch.core.struct import tree_paths
from repro_torch.hw.manycore import ManycoreCell, make_core_params
from repro_torch.hw.pipestage import PipeStage, make_chain
from repro_torch.hw.soc import Cpu, DramModel, soc_done, soc_graph, soc_partition
from repro_torch.hw.systolic import SystolicCell, make_cell_params
from repro_torch.kernels import fused_checks as fc
from repro_torch.kernels import granule_step


class _HalfRateCell(ManycoreCell):
    """A many-core cell stepped every other base-clock cycle."""

    clock_divider = 2


class _HalfRateMac(SystolicCell):
    """A systolic cell stepped every other base-clock cycle."""

    clock_divider = 2


def _values(R, C):
    return ((np.arange(R * C) % 8) + 1).astype(np.float32).reshape(R, C)


def _torus(R, C, cap, cell_cls=ManycoreCell):
    return ChannelGraph.torus(cell_cls(R, C), R, C,
                              params=make_core_params(_values(R, C)), capacity=cap)


def _batched(R=16, C=16, cap=4):
    """8 granules batched on one device, tiers (2, 4): boundary queues."""
    return FusedEngine(_torus(R, C, cap),
                       tiered_grid_partition(R, C, [(2, 1), (2, 2)]), None,
                       tiers=[(("pod",), 2), (("g",), 4)],
                       batch_axes={"pod": 2, "g": 4}, device="cpu")


def _single(cell_cls=ManycoreCell, R=8, C=8):
    """One granule: registers only, no boundary queues."""
    return FusedEngine(_torus(R, C, 4, cell_cls), None, None, K=4, device="cpu")


def _grid(tiles=(1, 1), M=12, R=8, C=8):
    A, B = fc.operands(M, R, C, seed=R + C)
    return FusedEngine.grid(SystolicCell(M), R, C, K=4, capacity=4,
                            params=make_cell_params(A, B), device="cpu",
                            batch_axes={"gr": tiles[0], "gc": tiles[1]})


def _two_group():
    A, B = fc.operands(10, 8, 6, seed=4)
    net, _ = fc.two_group_systolic(A, B, capacity=4, south_cls=_HalfRateMac)
    return net.build(engine="fused", session=False, device="cpu", K=3)


def _mixed(batched=False):
    A, B = fc.operands(9, 6, 5, seed=5)
    net, *_ = fc.mixed_network(A, B, 4, 5, capacity=4)
    if not batched:
        return net.build(engine="fused", session=False, device="cpu", K=4)
    part = np.arange(len(net._instances)) % 2
    return net.build(engine="fused", session=False, device="cpu", K=4,
                     partition=part, tiers=[(("g",), 4)], batch_axes={"g": 2})


def _soc(split=False):
    """16 SoCs: whole SoCs on 2 batched granules at K = 8, or (``split``)
    each block type on a granule of its own at K = 2, every channel a
    boundary egress and ingress row."""
    n = 16
    if split:
        return FusedEngine(soc_graph(n, capacity=4), np.tile(np.arange(3), n), None,
                           K=2, batch_axes={"g": 3}, overlap=False, device="cpu")
    return FusedEngine(soc_graph(n, capacity=4), soc_partition(n, 2), None, K=8,
                       batch_axes={"g": 2}, overlap=False, device="cpu")


ENGINES = {"torus16_8granules": _batched, "one_granule": _single,
           "divided_clock": lambda: _single(_HalfRateCell)}
MULTI = {"systolic_grid": _grid, "systolic_grid_2x2": lambda: _grid((2, 2)),
         "two_group_half_rate": _two_group, "mixed": _mixed,
         "mixed_2granules": lambda: _mixed(True), "soc": _soc}


def _cons(eng):
    tables = granule_step.consumer_table(
        eng._tx_flat, eng._inv_tx_flat, eng._inv_tx_mask_flat,
        eng._inv_rx_flat, eng._inv_rx_mask_flat, eng.B * eng.n_reg)
    assert all(t.dtype == np.int32 for t in tables)
    return [torch.as_tensor(t).long() for t in tables]


def consumer_ready(st, j, pj, chan_ready, cell, tx):
    """ManycoreCell's readiness on in port ``pj`` of slots ``j`` from their
    pre-cycle state (the kernel's ``core_ready``, clock enable aside);
    ``tx`` is the slots' output port table."""
    phase, sent, rcvd, fwd_v = st.phase[j], st.sent[j], st.rcvd[j], st.fwd_v[j]
    in_row = phase == 0
    need = torch.where(in_row, cell.C - 1, cell.R - 1)
    port_ok = (phase < 2) & ((pj == 0) == in_row) & (rcvd < need)
    will_fwd = rcvd < need - 1
    out_c = torch.where(in_row, 0, 1)
    # j frees its forward register only by sending a forward this cycle
    frees = (sent > 0) & (sent < need) & chan_ready(tx[j, out_c])
    return port_ok & (~will_fwd | ~fwd_v | frees)


def cell_ready(st, j, pj, chan_valid, chan_ready, cell, rx, tx):
    """SystolicCell's readiness on in port ``pj`` of slots ``j`` from their
    pre-cycle state (the kernel's ``cell_ready``, clock enable aside): its
    fire, the port not synthesized.  The asking register is full, so the
    input on ``pj`` counts as valid."""
    west, north = st.is_west[j], st.is_north[j]
    synth = torch.where(pj == 0, west, north)
    a_valid = (pj == 0) | torch.where(west, st.a_idx[j] < cell.m_stream,
                                      chan_valid(rx[j, 0]))
    psum_valid = (pj == 1) | north | chan_valid(rx[j, 1])
    e_rdy = st.is_east[j] | chan_ready(tx[j, 0])
    s_rdy = st.is_south[j] | chan_ready(tx[j, 1])
    return ~synth & a_valid & psum_valid & e_rdy & s_rdy


def one_pass_cycle(eng, carry, tb, cons):
    """One cycle as the kernel runs it: every slot of every group steps,
    then commits the registers it produces (consumer readiness recomputed
    through ``cons``, by the consumer group's type and clock) and the
    boundary rows on its one local side."""
    reg_val, reg_v, q, states, cycle = carry
    blocks = [g.block for g in eng.graph.groups]
    n_reg = reg_val.shape[0]
    rxs = [t.long() for t in tb.rx_idx]
    txs = [t.long() for t in tb.tx_idx]
    have_q = q.buf.shape[0] > 1
    size = (q.head - q.tail) % q.capacity

    def chan_valid(c):
        ok = reg_v[c.clamp(max=n_reg - 1)]
        if have_q:
            k = (c - n_reg).clamp(min=0)
            ok = torch.where(c < n_reg, ok, size[k] > 0)
        return ok

    def chan_front(c):
        w = reg_val[c.clamp(max=n_reg - 1)]
        if have_q:
            k = (c - n_reg).clamp(min=0)
            w = torch.where((c < n_reg)[:, None], w, q.buf[k, q.tail[k].long()])
        return w

    def chan_ready(c):
        ok = ~reg_v[c.clamp(max=n_reg - 1)]
        if have_q:
            k = (c - n_reg).clamp(min=0)
            ok = torch.where(c < n_reg, ok, size[k] < q.capacity - 1)
        return ok

    ens = [(cycle % blk.clock_divider) == 0 for blk in blocks]
    bases = np.cumsum([0] + [t.shape[0] * t.shape[1] for t in rxs])

    def ready(ids):
        """Readiness of the flat consumers ``ids`` (>= 0), clocks included."""
        out = torch.zeros(ids.shape, dtype=torch.bool)
        for gi, blk in enumerate(blocks):
            m = (ids >= int(bases[gi])) & (ids < int(bases[gi + 1]))
            k = ids[m] - int(bases[gi])
            n_in = rxs[gi].shape[1]
            if n_in == 0:  # the ramp: no in port, never a consumer
                continue
            j, pj = k // n_in, k % n_in
            if isinstance(blk, ManycoreCell):
                r = consumer_ready(states[gi], j, pj, chan_ready, blk, txs[gi])
            elif isinstance(blk, PipeStage):
                r = chan_ready(txs[gi][j, 0])  # the kernel's pipe_ready
            elif isinstance(blk, Cpu):
                r = (pj == 1) | states[gi].waiting[j]  # the kernel's cpu_ready
            elif isinstance(blk, DramModel):
                r = ~states[gi].has_pending[j]  # the kernel's dram_ready
            else:
                r = cell_ready(states[gi], j, pj, chan_valid, chan_ready, blk,
                               rxs[gi], txs[gi])
            out[m] = r & ens[gi]
        return out

    reg_val2, reg_v2 = reg_val.clone(), reg_v.clone()
    head2, tail2, buf2 = q.head.clone(), q.tail.clone(), q.buf.clone()
    new_states = []
    for gi, blk in enumerate(blocks):
        rx, tx, st, en = rxs[gi], txs[gi], states[gi], ens[gi]
        rxd = {p: (chan_front(rx[:, i]), chan_valid(rx[:, i]))
               for i, p in enumerate(blk.in_ports)}
        txr = {p: chan_ready(tx[:, i]) for i, p in enumerate(blk.out_ports)}
        new_st, rr, txo = blk.step(st, rxd, txr)
        if blk.clock_divider > 1:
            new_st = type(st)(**{f: torch.where(en, getattr(new_st, f), getattr(st, f))
                                 for f in st._data_fields})
        new_states.append(new_st)
        for i, port in enumerate(blk.out_ports):
            c, cn = tx[:, i], cons[gi][:, i]
            pay, val = txo[port]
            val = val & en
            is_reg = (cn != -2) & (c < n_reg)
            ci = c[is_reg]
            v = reg_v[ci]
            push = val[is_reg] & ~v
            has_cons = cn[is_reg] >= 0
            pop = v & has_cons & ready(cn[is_reg].clamp(min=0))
            reg_v2[ci] = (v & ~pop) | push
            reg_val2[ci] = torch.where(push[:, None], pay[is_reg].to(reg_val.dtype),
                                       reg_val[ci])
            if have_q:
                egress = (cn != -2) & (c >= n_reg)
                assert (cn[egress] == -1).all()
                k = c[egress] - n_reg
                h = q.head[k]
                ok = val[egress] & ((h + 1) % q.capacity != q.tail[k])
                buf2[k[ok], h[ok].long()] = pay[egress][ok].to(q.buf.dtype)
                head2[k] = torch.where(ok, (h + 1) % q.capacity, h)
        if have_q:
            for i, port in enumerate(blk.in_ports):
                c = rx[:, i]
                ingress = c >= n_reg
                k = c[ingress] - n_reg
                pop = rr[port][ingress] & en & (size[k] > 0)
                tail2[k] = torch.where(pop, (q.tail[k] + 1) % q.capacity, q.tail[k])
    q2 = q.replace(buf=buf2, head=head2, tail=tail2)
    return (reg_val2, reg_v2, q2, tuple(new_states), cycle + 1)


def _leaves(carry):
    return dict(tree_paths(carry))


def _run_one_pass(eng, done, which):
    """The plain cycle and the one-pass emulation from the same pre-cycle
    carry on every cycle, exchanges between the cycle blocks as the
    engine's program places them, every leaf bit-exact, until ``done``
    holds on the block states.  Returns (block states, registers popped)."""
    cons = _cons(eng)
    local = eng._local_view(eng.init(0))
    tb = eng._consts(local.tables)
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    program = eng._resident_program(0)
    cycles = pops = 0
    for epoch in range(200):
        for op, arg in program:
            if op == "X":
                carry = eng._resident_exchange(carry, arg, tb)
                continue
            for _ in range(arg):
                want = eng._cycle_body(carry[:5], tb)
                got = one_pass_cycle(eng, carry[:5], tb, cons)
                a, b = _leaves(got), _leaves(want)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert torch.equal(a[k], b[k]), (which, cycles, k)
                pops += int((carry[1] & ~want[1]).sum())
                carry = want + (carry[5],)
                cycles += 1
        if done(carry[3]):
            break
    assert done(carry[3]), f"{which} did not finish"
    return carry[3], pops


@pytest.mark.parametrize("which", list(ENGINES))
def test_one_pass_cycle_matches_plain_cycle(which):
    """Every leaf bit-exact after every cycle, exchanges between the cycle
    blocks as the engine's program places them, to convergence."""
    eng = ENGINES[which]()
    states, pops = _run_one_pass(
        eng, lambda st: bool((st[0].phase == 2).all()), which)
    assert pops > 0
    total = float(_values(eng.graph.groups[0].block.R,
                          eng.graph.groups[0].block.C).sum())
    assert bool((states[0].total == total).all())


@pytest.mark.parametrize("which", list(MULTI))
def test_one_pass_cycle_matches_plain_cycle_across_groups(which):
    """The same for SystolicCell groups and for several groups of one or
    two block types, whose consumers sit in other groups (of another type,
    on another clock): every leaf bit-exact on every cycle, to the end of
    the run (every south cell collected M outputs; the torus converged)."""
    eng = MULTI[which]()
    blocks = [g.block for g in eng.graph.groups]
    done = lambda states: fc.blocks_done(blocks, states)  # noqa: E731
    states, pops = _run_one_pass(eng, done, which)
    assert pops > 0
    for blk, st in zip(blocks, states):
        if isinstance(blk, ManycoreCell):
            assert bool((st.total == float(_values(blk.R, blk.C).sum())).all())
    assert len(blocks) == {"systolic_grid": 1, "systolic_grid_2x2": 1,
                           "two_group_half_rate": 2}.get(which, 3)


@pytest.mark.parametrize("which", list(ENGINES))
def test_consumer_table(which):
    """Each output port's consumer is the slot and in port whose input is
    the same channel; queue rows have no local consumer, and a row with two
    local sides raises."""
    eng = ENGINES[which]()
    cons = _cons(eng)[0]
    rx, tx = eng._rx_flat[0][0], eng._tx_flat[0][0]
    n_reg = eng.B * eng.n_reg
    n_slot = tx.shape[0]
    assert cons.shape == (n_slot, 2)
    for i in range(n_slot):
        for p in range(2):
            c, cn = int(tx[i, p]), int(cons[i, p])
            if cn >= 0:
                assert c < n_reg and int(rx[cn // 2, cn % 2]) == c
            elif cn == -1:
                assert c >= n_reg  # a boundary egress row
            else:
                assert cn == -2 and c < n_reg and c % eng.n_reg < 2
    # torus cores drive every port: the registers all have a consumer
    assert int((cons == -2).sum()) == 0
    assert (eng.B > 1) == bool((cons == -1).any())
    if eng.B > 1:
        # an egress row given a local consumer too breaks the rule
        inv_rx_mask = eng._inv_rx_mask_flat.copy()
        row = int(tx[(cons == -1).nonzero()[0, 0], (cons == -1).nonzero()[0, 1]])
        inv_rx_mask[0, row] = True
        with pytest.raises(NotImplementedError, match="one local side"):
            granule_step.consumer_table(
                eng._tx_flat, eng._inv_tx_flat, eng._inv_tx_mask_flat,
                eng._inv_rx_flat, inv_rx_mask, n_reg)
    # a port whose channel names another producer is not SPSC
    inv_tx = eng._inv_tx_flat.copy()
    c0 = int(tx[0, 0])
    inv_tx[0, c0] = inv_tx[0, int(tx[1, 0])]
    with pytest.raises(ValueError, match="another producer"):
        granule_step.consumer_table(
            eng._tx_flat, inv_tx, eng._inv_tx_mask_flat,
            eng._inv_rx_flat, eng._inv_rx_mask_flat, n_reg)


@pytest.mark.parametrize("granules", [1, 2])
def test_one_pass_cycle_matches_plain_cycle_pipestage_chain(granules):
    """PipeStage's device step as the kernel runs it (one port column, one
    flat consumer id a slot): an 8-stage chain fed and drained by the host
    between epochs, on one granule and on two batched ones (a boundary
    egress and ingress row), every leaf bit-exact on every cycle."""
    net = make_chain(8, capacity=4, delta=0.5)
    kw = (dict(K=4) if granules == 1 else
          dict(K=4, partition=[0] * 4 + [1] * 4, tiers=[(("g",), 4)],
               batch_axes={"g": 2}))
    eng = net.build(engine="fused", session=False, device="cpu", **kw)
    cons = _cons(eng)
    assert cons[0].shape == (8, 1)
    state = eng.init(0)
    program = eng._resident_program(0)
    got_out, sent, cycles = [], 0, 0
    for epoch in range(40):
        if sent < 40:
            batch = torch.tensor([[float(sent + j), float(epoch)] for j in range(3)])
            state, n = eng.host_push_many(state, "tx", batch)
            sent += int(n)
        local = eng._local_view(state)
        tb = eng._consts(local.tables)
        carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
                 local.cycle, local.credits)
        for op, arg in program:
            if op == "X":
                carry = eng._resident_exchange(carry, arg, tb)
                continue
            for _ in range(arg):
                want = eng._cycle_body(carry[:5], tb)
                got = one_pass_cycle(eng, carry[:5], tb, cons)
                a, b = _leaves(got), _leaves(want)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert torch.equal(a[k], b[k]), (granules, cycles, k)
                carry = want + (carry[5],)
                cycles += 1
        state = eng._global_view(local.replace(
            reg_val=carry[0], reg_v=carry[1], queues=carry[2],
            block_states=carry[3], cycle=carry[4], credits=carry[5],
            epoch=local.epoch + 1))
        state, out, n = eng.host_pop_many(state, "rx", 8)
        got_out.append(out[: int(n)])
    out = torch.cat(got_out)
    assert sent == out.shape[0] and sent > 30
    # each of the 8 stages adds 0.5 to word 0, in order
    torch.testing.assert_close(out[:, 0], torch.arange(sent, dtype=torch.float32) + 4.0,
                               rtol=0, atol=0)
    assert bool((carry[3][0].count == sent).all())


def test_one_pass_cycle_matches_plain_cycle_soc_type_a_granule():
    """The SoC's three types each on a granule of their own (the example's
    split): every channel is a boundary egress row at its producer and an
    ingress row at its consumer, the ramp's rows on a quarter-rate clock;
    every leaf bit-exact on every cycle until every CPU retired its reads
    (the padding slots of each granule masked)."""
    eng = _soc(split=True)
    active = eng._local_view(eng.init(0)).tables.active[0]
    states, _ = _run_one_pass(eng, lambda st: bool(soc_done(st[0], active)),
                              "soc_type_a_granule")
    assert bool(((states[0].n_done == 8) | ~active).all())
    assert int(active.sum()) == 16 and int(eng.n_q) > 1
