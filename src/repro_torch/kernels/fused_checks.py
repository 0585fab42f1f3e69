"""Systems for the fused engine's CUDA program beyond one group of
``ManycoreCell``, and the check that holds the kernel against its plain
version on the card; shared by ``tests/test_torch_kernel.py``,
``tests/test_torch_fused_grid.py``, ``tests/test_torch_granule_schedule.py``
and ``chip_smoke.py``.

The network builders take a *kit* of the block and builder classes
(:func:`port_kit` by default), so a test builds the same system, channel
for channel, in the JAX package by passing that package's classes:

  * :func:`two_group_systolic`: the systolic grid for ``A @ B`` with the
    north half of its rows instantiated from one ``SystolicCell`` object
    and the rest from another (two groups of one type, every south link
    between the halves a channel across groups);
  * :func:`mixed_network`: a ``ManycoreCell`` torus running its allreduce,
    with a ``SystolicCell`` relay (``is_north``, ``is_south``: it passes
    each west packet east unchanged) inserted in every row ring, beside a
    systolic grid for ``A @ B`` — three groups of two types, with channels
    from one type to the other both ways.

:func:`check_engine` and :func:`check_io` need a CUDA device and raise
``AssertionError`` on a mismatch; :func:`seed_registers` fills a closed
network's registers (a ``PipeStage`` ring has no host port to feed it).
"""
from __future__ import annotations

import types

import numpy as np
import torch

from ..core.struct import tree_map, tree_paths
from ..obs import trace as _trace
from . import granule_step


def port_kit() -> types.SimpleNamespace:
    """The port's classes for the builders below."""
    from ..core.network import Network
    from ..hw.manycore import CoreParams, ManycoreCell
    from ..hw.systolic import SystolicCell, SystolicParams, make_cell_params

    return types.SimpleNamespace(
        Network=Network, ManycoreCell=ManycoreCell, CoreParams=CoreParams,
        SystolicCell=SystolicCell, SystolicParams=SystolicParams,
        make_cell_params=make_cell_params)


def operands(M: int, R: int, C: int, seed: int):
    """``A`` (M, R) and ``B`` (R, C), standard normal f32 from ``seed``."""
    rng = np.random.RandomState(seed)
    return rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)


def _cell_params(kit, P, r: int, c: int):
    """One cell's params out of the stacked ``make_cell_params`` arrays."""
    return kit.SystolicParams(**{f: getattr(P, f)[r, c] for f in (
        "b", "is_west", "is_north", "is_south", "is_east", "a_buf")})


def _add_grid(kit, net, A, B, cells):
    """Instantiate the R x C grid for ``A @ B``, row r from ``cells[r]``,
    and wire it east and south; returns the instances, row-major."""
    R, C = B.shape
    P = kit.make_cell_params(A, B)
    grid = [[net.instantiate(cells[r], name=f"c{r}_{c}",
                             params=_cell_params(kit, P, r, c))
             for c in range(C)] for r in range(R)]
    for r in range(R):
        for c in range(C):
            if c + 1 < C:
                net.connect(grid[r][c]["e_out"], grid[r][c + 1]["w_in"])
            if r + 1 < R:
                net.connect(grid[r][c]["s_out"], grid[r + 1][c]["n_in"])
    return grid


def two_group_systolic(A, B, kit=None, capacity: int = 8, south_cls=None):
    """(network, grid): ``A @ B`` on a grid whose north ``R // 2`` rows are
    one ``SystolicCell`` object and the rest another (of ``south_cls``,
    the kit's ``SystolicCell`` by default)."""
    kit = kit or port_kit()
    M, R = A.shape
    north = kit.SystolicCell(m_stream=M)
    south = (south_cls or kit.SystolicCell)(m_stream=M)
    net = kit.Network(payload_words=2, capacity=capacity)
    grid = _add_grid(kit, net, A, B, [north if r < R // 2 else south
                                      for r in range(R)])
    return net, grid


def torus_values(R: int, C: int) -> np.ndarray:
    return ((np.arange(R * C) % 8) + 1).astype(np.float32).reshape(R, C)


def mixed_network(A, B, R2: int, C2: int, kit=None, capacity: int = 8):
    """(network, torus, relays, grid): an R2 x C2 ``ManycoreCell`` torus
    (values ``torus_values``) whose row r ring runs through a
    ``SystolicCell`` relay between its last and first core, and the
    systolic grid for ``A @ B``, in one network.  The relays sit in the
    east links, so the row phase of the allreduce crosses from one block
    type to the other and back; every core's total is still the global
    sum."""
    kit = kit or port_kit()
    M = A.shape[0]
    net = kit.Network(payload_words=2, capacity=capacity)
    core = kit.ManycoreCell(R2, C2)
    vals = torus_values(R2, C2)
    torus = [[net.instantiate(core, name=f"m{r}_{c}",
                              params=kit.CoreParams(value=vals[r, c]))
              for c in range(C2)] for r in range(R2)]
    relay = kit.SystolicCell(m_stream=M)
    t, f = np.bool_(True), np.bool_(False)
    relays = [net.instantiate(relay, name=f"relay{r}", params=kit.SystolicParams(
        b=np.float32(0.5 + r), is_west=f, is_north=t, is_south=t, is_east=f,
        a_buf=np.zeros((M,), np.float32))) for r in range(R2)]
    grid = _add_grid(kit, net, A, B, [kit.SystolicCell(m_stream=M)] * B.shape[0])
    for r in range(R2):
        for c in range(C2):
            nxt = torus[r][c + 1]["w_in"] if c + 1 < C2 else relays[r]["w_in"]
            net.connect(torus[r][c]["e_out"], nxt)
            net.connect(torus[r][c]["s_out"], torus[(r + 1) % R2][c]["n_in"])
        net.connect(relays[r]["e_out"], torus[r][0]["w_in"])
    return net, torus, relays, grid


def clone(state):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                    state)


def plain_epochs(eng, state, n: int = 1):
    """``n`` epochs of a fused engine through the plain version,
    ``granule_step.epoch_program_ref``, called by name, on the state's own
    device (the card, for a CUDA state): the yardstick of the kernel."""
    local = eng._local_view(state)
    for _ in range(n):
        local = eng._epoch(local, program=granule_step.epoch_program_ref)
    return eng._global_view(local)


def compare(a, b) -> float:
    """Max |a - b| over every leaf of two fused states (tables excluded),
    compared where ``a`` lies (floats as bits, so -0.0 is not 0.0); raises
    unless every leaf is bit-exact."""
    la = dict(tree_paths(a.replace(tables=None)))
    lb = dict(tree_paths(b.replace(tables=None)))
    if sorted(la) != sorted(lb):
        raise AssertionError(f"leaf sets differ: {sorted(la)} vs {sorted(lb)}")
    worst, bad = 0.0, []
    for k, x in la.items():
        y = lb[k].to(x.device)
        if x.shape != y.shape or x.dtype != y.dtype:
            bad.append(k)
        elif x.dtype == torch.float32:
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                bad.append(k)
                worst = max(worst, float((x - y).abs().max()))
        elif not torch.equal(x, y):
            bad.append(k)
    if bad:
        raise AssertionError(f"kernel and plain version differ in {bad} "
                             f"(max |diff| of the floats {worst})")
    return worst


def check_engine(eng, done, max_epochs: int, state=None) -> tuple:
    """A fused engine on the card: epochs through the kernel against epochs
    through the plain version on a copy (both on the card), every state
    leaf bit-exact after every epoch, until ``done(local)`` holds (or
    ``max_epochs``).  Returns (epochs run, the kernel's final state);
    raises if the run did not finish or the kernel was not launched once
    an epoch."""
    kern = eng.init(0) if state is None else state
    plain = clone(kern)
    before = granule_step.launches
    for ep in range(max_epochs):
        if bool(done(eng._local_view(kern))):
            break
        kern = eng.run_epochs(kern, 1)
        plain = plain_epochs(eng, plain)
        torch.cuda.synchronize()
        try:
            compare(kern, plain)
        except AssertionError as e:
            raise AssertionError(f"epoch {ep + 1}: {e}") from None
    else:
        raise AssertionError(f"not done after {max_epochs} epochs")
    if granule_step.launches - before != ep:
        raise AssertionError(f"{granule_step.launches - before} kernel launches "
                             f"for {ep} epochs")
    return ep, kern


def check_io(eng, n_epochs: int, seed: int = 0) -> int:
    """A fused engine with host ports ``"tx"`` and ``"rx"`` on the card:
    the same pseudo-random host pushes before every epoch and pops after
    it, epochs through the kernel and through the plain version on a copy
    (both on the card), every state leaf bit-exact after every epoch and
    every popped packet equal.  Returns the packets popped; raises if the
    kernel was not launched once an epoch."""
    rng = np.random.RandomState(seed)
    kern = eng.init(0)
    plain = clone(kern)
    before, popped = granule_step.launches, 0
    for ep in range(n_epochs):
        k = int(rng.randint(0, 4))
        if k:
            batch = np.array([[100.0 * ep + j, float(ep)] for j in range(k)], np.float32)
            kern, n1 = eng.host_push_many(kern, "tx", batch)
            plain, n2 = eng.host_push_many(plain, "tx", batch)
            if int(n1) != int(n2):
                raise AssertionError(f"epoch {ep}: pushed {int(n1)} against {int(n2)}")
        kern = eng.run_epochs(kern, 1)
        plain = plain_epochs(eng, plain)
        torch.cuda.synchronize()
        try:
            compare(kern, plain)
        except AssertionError as e:
            raise AssertionError(f"epoch {ep + 1}: {e}") from None
        kern, a, na = eng.host_pop_many(kern, "rx", 4)
        plain, b, nb = eng.host_pop_many(plain, "rx", 4)
        if int(na) != int(nb) or not torch.equal(a[: int(na)].view(torch.int32),
                                                 b[: int(nb)].view(torch.int32)):
            raise AssertionError(f"epoch {ep + 1}: popped packets differ")
        popped += int(na)
    if granule_step.launches - before != n_epochs:
        raise AssertionError(f"{granule_step.launches - before} kernel launches "
                             f"for {n_epochs} epochs")
    return popped


def seed_registers(state, every: int = 3):
    """``state`` with every ``every``-th register of each granule from id 2
    on (0 and 1 are the sentinels) full, word 0 its id and word 1 the
    granule row: packets in flight for a network without host ports."""
    reg_v, reg_val = state.reg_v.clone(), state.reg_val.clone()
    ids = torch.arange(2, reg_v.shape[-1], every, device=reg_v.device)
    reg_v[..., ids] = True
    reg_val[..., ids, 0] = ids.to(reg_val.dtype)
    rows = torch.arange(reg_val[..., 0, 0].numel(), device=reg_val.device)
    reg_val[..., ids, 1] = rows.reshape(reg_val.shape[:-2] + (1,)).to(reg_val.dtype)
    return state.replace(reg_v=reg_v, reg_val=reg_val)


def south_done(cells, M: int):
    """Every south cell of a grid group collected ``M`` outputs."""
    return ((~cells.is_south) | (cells.y_idx >= M)).all()


def blocks_done(blocks, states) -> torch.Tensor:
    """() bool on the states' device — the end of a run of the systems
    here: every ``ManycoreCell`` group finished its allreduce, every
    ``SystolicCell`` group with west cells (a grid; the relays stream
    nothing) collected ``M`` outputs at each south cell, and every ``Cpu``
    retired its reads (``hw.soc.soc_done``).  Nothing is read back to the
    host, so it serves as a device loop's predicate."""
    from ..hw.manycore import ManycoreCell
    from ..hw.soc import Cpu, soc_done
    from ..hw.systolic import SystolicCell

    device = next(x for _, x in tree_paths(states[0])).device
    done = torch.ones((), dtype=torch.bool, device=device)
    for blk, st in zip(blocks, states):
        if isinstance(blk, ManycoreCell):
            done = done & (st.phase == 2).all()
        elif isinstance(blk, SystolicCell):
            done = done & (~st.is_west.any() | south_done(st, blk.m_stream))
        elif isinstance(blk, Cpu):
            done = done & soc_done(st)
    return done


def network_done(eng):
    """``blocks_done`` as a ``run_until`` predicate of ``eng``."""
    blocks = [g.block for g in eng.graph.groups]
    return lambda local: blocks_done(blocks, local.block_states)


def grid_result(eng, state, gi: int, R: int, C: int, M: int) -> np.ndarray:
    """``Y`` (M, C) from the south row of the R x C grid held by group
    ``gi`` (its members in row-major order), gathered where the state lies
    (only those C rows of ``y_buf`` come to the host); traced as a
    ``session.read`` span."""
    n_slot = eng._n_slot[gi]
    flat = eng._member_granule[gi] * n_slot + eng._member_slot[gi]
    with _trace.recorder().session_span("session.read", api="grid_result"):
        y = state.block_states[gi].y_buf
        rows = torch.as_tensor(flat[(R - 1) * C:R * C], device=y.device)
        return y.reshape(-1, M)[rows].cpu().numpy().T
