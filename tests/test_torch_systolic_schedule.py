"""The window schedule of ``csrc/systolic_step.cu``, emulated in plain
PyTorch on the CPU, against ``systolic_step_ref`` (the plain version, held
against the JAX package in ``tests/test_torch_systolic.py``), and the
kernel's plan (``systolic_step.tile_plan``).

The kernel runs a call of K cycles as ceil(K / k) launches.  In a launch
each CTA loads its block of cells and a halo of k cells on every side
(clipped at the tile's edges), runs k cycles there, and keeps only its own
block, the counters of its own rows and columns, the slab entries and the
``y_buf`` entries its cells emit.  ``window_call`` below does the same,
window by window with whole-tensor ops (a side of a window that is not
the tile's edge is a cut: nothing comes in across it and nothing drains
across it), and must give the plain version's whole call.
Tolerance is exact: integer logic and one FMA a fire.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.fastgrid import RegisterGridEngine
from repro_torch.kernels import systolic_step as sk
from repro_torch.kernels.systolic_step import (
    CELL_OUT, EDGE_OUT, systolic_step_ref, tile_plan, window_smem,
)

PAIRED = ("a_reg", "a_v", "p_reg", "p_v", "a_idx")
COUNTERS = ("widx", "east_cnt", "nidx", "south_cnt")


def _window_cycles(w: dict, kk: int, edge: dict, st: dict, t: int,
                   rows: slice, cols: slice, own: tuple, slabs: dict) -> None:
    """``kk`` cycles of one window as a CTA runs them, in place on the
    window's tensors ``w`` and counters: pass 1 evaluates every cell's fire
    once (a cut side has no neighbour: nothing valid comes in, nothing
    drains); pass 2 latches and drains.  ``edge`` says which window sides
    are the tile's edges; ``own`` is the owned rows and columns (window
    slices) and whether the block holds column C-1 and row R-1: only there
    do cells write the egress slabs."""
    M = st["a_buf"].shape[-1]
    W = st["west_slab"].shape[-1]
    is_w, is_n, is_s, is_e = (w[k] for k in ("is_west", "is_north", "is_south", "is_east"))
    R, C = st["b"].shape[-2:]
    wr, wc = w["b"].shape
    zero = torch.zeros((), dtype=torch.float32)
    orow, ocol, owns_east, owns_south = own
    for _ in range(kk):
        a_reg, a_v, p_reg, p_v = w["a_reg"], w["a_v"], w["p_reg"], w["p_v"]
        # west input: the window's column 0 reads the slab on the tile's edge
        if edge["west"]:
            wi = w["widx"]
            slab = st["west_slab"][t, rows].gather(
                -1, wi.clamp(0, W - 1)[:, None].long())[:, 0]
            col0 = (torch.where((wi >= 0) & (wi < W), slab, zero),
                    wi < st["west_cnt"][t, rows])
        else:
            col0 = (torch.zeros(wr), torch.zeros(wr, dtype=torch.bool))
        w_val = torch.cat([col0[0][:, None], a_reg[:, :-1]], 1)
        w_vld = torch.cat([col0[1][:, None], a_v[:, :-1]], 1)
        if edge["north"]:
            ni = w["nidx"]
            slab = st["north_slab"][t, cols].gather(
                -1, ni.clamp(0, W - 1)[:, None].long())[:, 0]
            row0 = (torch.where((ni >= 0) & (ni < W), slab, zero),
                    ni < st["north_cnt"][t, cols])
        else:
            row0 = (torch.zeros(wc), torch.zeros(wc, dtype=torch.bool))
        n_val = torch.cat([row0[0][None, :], p_reg[:-1]], 0)
        n_vld = torch.cat([row0[1][None, :], p_v[:-1]], 0)
        ai = w["a_idx"]
        a_src = w["a_buf"].gather(-1, ai.clamp(0, M - 1)[..., None].long())[..., 0]
        a_src = torch.where((ai >= 0) & (ai < M), a_src, zero)
        a_in = torch.where(is_w, a_src, w_val)
        a_ok = torch.where(is_w, ai < M, w_vld)
        p_in = torch.where(is_n, zero, n_val)
        p_ok = is_n | n_vld
        e_free, s_free = ~a_v, ~p_v
        if edge["east"]:
            e_free[:, -1] = w["east_cnt"] < st["east_limit"][t, rows]
        if edge["south"]:
            s_free[-1, :] = w["south_cnt"] < st["south_limit"][t, cols]
        fire = a_ok & p_ok & (e_free | is_e) & (s_free | is_s)
        y = sk.mac(p_in, a_in, w["b"])
        # pass 2: a neighbour outside the window drains nothing
        cons_a, cons_p = fire & ~is_w, fire & ~is_n
        drain_a = torch.cat([cons_a[:, 1:], torch.zeros(wr, 1, dtype=torch.bool)], 1)
        drain_p = torch.cat([cons_p[1:], torch.zeros(1, wc, dtype=torch.bool)], 0)
        emit_e, emit_s = fire & ~is_e, fire & ~is_s
        a_v2, p_v2 = a_v & ~drain_a, p_v & ~drain_p
        new_a_v, new_p_v = emit_e | a_v2, emit_s | p_v2
        if edge["east"]:
            new_a_v[:, -1] = a_v2[:, -1]
        if edge["south"]:
            new_p_v[-1, :] = p_v2[-1, :]
        if edge["west"]:
            w["widx"] = w["widx"] + cons_a[:, 0].int()
        if edge["north"]:
            w["nidx"] = w["nidx"] + cons_p[0].int()
        if owns_east:
            for r in range(orow.start, orow.stop):
                ec = int(w["east_cnt"][r])
                if emit_e[r, -1] and 0 <= ec < W:
                    slabs["east"][t, rows.start + r, ec] += a_in[r, -1]
        if edge["east"]:
            w["east_cnt"] = w["east_cnt"] + emit_e[:, -1].int()
        if owns_south:
            for c in range(ocol.start, ocol.stop):
                sc = int(w["south_cnt"][c])
                if emit_s[-1, c] and 0 <= sc < W:
                    slabs["south"][t, cols.start + c, sc] += y[-1, c]
        if edge["south"]:
            w["south_cnt"] = w["south_cnt"] + emit_s[-1].int()
        collect = fire & is_s
        yi = w["y_idx"]
        hit = collect & (yi >= 0) & (yi < M)
        w["y_buf"] = w["y_buf"] + torch.where(
            hit[..., None] & (torch.arange(M) == yi[..., None]), y[..., None], zero)
        w["y_idx"] = yi + collect.int()
        w.update(a_reg=torch.where(fire, a_in, a_reg), p_reg=torch.where(fire, y, p_reg),
                 a_v=new_a_v, p_v=new_p_v, a_idx=ai + (fire & is_w).int())


def window_call(state: dict, K: int, plan, halo_less: int = 0) -> dict:
    """A call of ``K`` cycles as the kernel runs it under ``plan`` (every
    leaf carries one leading tile dim here).  ``halo_less`` shrinks the
    halo below the cycles a launch runs (the test that it matters)."""
    st = {k: v.clone() for k, v in state.items()}
    T, R, C = st["b"].shape
    W = st["west_slab"].shape[-1]
    if "east_limit" not in st:
        st["east_limit"], st["south_limit"] = sk._limits(st)
    cur = {k: st[k].clone() for k in PAIRED}
    cnt = {k: torch.zeros((T, R if k in ("widx", "east_cnt") else C), dtype=torch.int32)
           for k in COUNTERS}
    slabs = {"east": torch.zeros((T, R, W)), "south": torch.zeros((T, C, W))}
    br, bc = plan.block
    done = launches = 0
    while done < K:
        kk = min(plan.k, K - done)
        h = kk - halo_less
        nxt = {k: v.clone() for k, v in cur.items()}
        ncnt = {k: v.clone() for k, v in cnt.items()}
        for t in range(T):
            for r0 in range(0, R, br):
                for c0 in range(0, C, bc):
                    r1, c1 = min(R, r0 + br), min(C, c0 + bc)
                    rows = slice(max(0, r0 - h), min(R, r1 + h))
                    cols = slice(max(0, c0 - h), min(C, c1 + h))
                    w = {k: cur[k][t, rows, cols].clone() for k in PAIRED}
                    w.update({k: st[k][t, rows, cols].clone() for k in (
                        "b", "is_west", "is_north", "is_south", "is_east",
                        "a_buf", "y_buf", "y_idx")})
                    w.update(widx=cnt["widx"][t, rows].clone(),
                             east_cnt=cnt["east_cnt"][t, rows].clone(),
                             nidx=cnt["nidx"][t, cols].clone(),
                             south_cnt=cnt["south_cnt"][t, cols].clone())
                    edge = {"west": cols.start == 0, "north": rows.start == 0,
                            "east": cols.stop == C, "south": rows.stop == R}
                    orow = slice(r0 - rows.start, r1 - rows.start)
                    ocol = slice(c0 - cols.start, c1 - cols.start)
                    _window_cycles(w, kk, edge, st, t, rows, cols,
                                   (orow, ocol, c1 == C, r1 == R), slabs)
                    for k in PAIRED:
                        nxt[k][t, r0:r1, c0:c1] = w[k][orow, ocol]
                    st["y_idx"][t, r0:r1, c0:c1] = w["y_idx"][orow, ocol]
                    st["y_buf"][t, r0:r1, c0:c1] = w["y_buf"][orow, ocol]
                    if c0 == 0:
                        ncnt["widx"][t, r0:r1] = w["widx"][orow]
                    if r0 == 0:
                        ncnt["nidx"][t, c0:c1] = w["nidx"][ocol]
                    if c1 == C:
                        ncnt["east_cnt"][t, r0:r1] = w["east_cnt"][orow]
                    if r1 == R:
                        ncnt["south_cnt"][t, c0:c1] = w["south_cnt"][ocol]
        cur, cnt = nxt, ncnt
        done += kk
        launches += 1
    assert launches == plan.launches
    res = dict(st)
    res.update(cur)
    res.update(cnt)
    res.update(east_slab=slabs["east"], south_slab=slabs["south"])
    return res


def _flat_tiles(d: dict) -> dict:
    """(Dr, Dc, ...) tile dims folded into one (the kernel's T)."""
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in d.items()}


def _engine_state(M, R, C, tiles, K, epochs, seed=0):
    """The kernel's input at the register engine's epoch ``epochs``."""
    rng = np.random.RandomState(seed)
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    eng = RegisterGridEngine(R, C, K=K, m_stream=M, tiles=tiles, device="cpu")
    st = eng.run_epochs(eng.init(A, B), epochs)
    return _flat_tiles(dict(
        st.cell, west_slab=st.west_slab, west_cnt=st.west_cnt,
        north_slab=st.north_slab, north_cnt=st.north_cnt,
        east_limit=torch.clamp(st.credit_e, max=K),
        south_limit=torch.clamp(st.credit_s, max=K)))


def _interior_state(seed=1, R=7, C=9, M=6, W=16, limits=(3, 2)):
    """A tile with no grid edge, fed through random slabs, emission limits
    below the cycles run."""
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(1, *s).astype(np.float32))  # noqa: E731
    z = lambda dt, *s: torch.zeros((1,) + (s or (R, C)), dtype=dt)  # noqa: E731
    full = lambda n, v: torch.full((1, n), v, dtype=torch.int32)  # noqa: E731
    return dict(
        b=f(R, C), a_reg=f(R, C), a_v=torch.from_numpy(rng.rand(1, R, C) < 0.5),
        p_reg=f(R, C), p_v=torch.from_numpy(rng.rand(1, R, C) < 0.5),
        a_idx=z(torch.int32), y_idx=z(torch.int32), a_buf=z(torch.float32, R, C, M),
        y_buf=z(torch.float32, R, C, M), is_west=z(torch.bool),
        is_north=z(torch.bool), is_south=z(torch.bool), is_east=z(torch.bool),
        west_slab=f(R, W), west_cnt=full(R, 11), north_slab=f(C, W),
        north_cnt=full(C, 12), east_limit=full(R, limits[0]),
        south_limit=full(C, limits[1]))


STATES = {
    # (M, R, C) = (12, 14, 10) at 2x2 engine tiles (7 x 5 each), mid-run
    "tiles2x2": lambda: _engine_state(12, 14, 10, (2, 2), 8, 3),
    # one 13 x 11 tile from the start: the west stream and south collection
    "one_tile": lambda: _engine_state(9, 13, 11, (1, 1), 8, 0, seed=2),
    "interior": _interior_state,
}


def _assert_call_equal(got, want, where):
    for k in CELL_OUT + EDGE_OUT:
        assert torch.equal(got[k], want[k]), (where, k)


@pytest.mark.parametrize("which", list(STATES))
@pytest.mark.parametrize("K", [2, 7, 16])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_window_schedule_matches_plain_call(which, K, k):
    """Blocks of 3 x 4 cells (dividing neither R nor C) with a halo of the
    cycles a launch runs: the kept cells, counters, slabs and ``y_buf``
    equal the plain version's K-cycle call."""
    st = STATES[which]()
    R, C = st["b"].shape[-2:]
    plan = tile_plan(R, C, K, k=k, block=(3, 4))
    assert plan.block == (3, 4) and plan.k == k
    want = systolic_step_ref(dict(st), K)
    _assert_call_equal(window_call(st, K, plan), want, (which, K, k))


def test_window_schedule_needs_its_halo():
    """With a halo one cell short of the cycles a launch runs the kept
    cells go wrong: the test above can tell a halo that is too small."""
    st = STATES["tiles2x2"]()
    R, C = st["b"].shape[-2:]
    plan = tile_plan(R, C, 7, k=3, block=(3, 4))
    want = systolic_step_ref(dict(st), 7)
    got = window_call(st, 7, plan, halo_less=1)
    assert any(not torch.equal(got[k], want[k]) for k in CELL_OUT + EDGE_OUT)


SYS_SMALL = [(12, 8, 8, (1, 1)), (33, 17, 23, (1, 1)), (12, 8, 8, (2, 2)),
             (33, 18, 24, (2, 2))]


@pytest.mark.parametrize("M,R,C,tiles", SYS_SMALL + [(1024, 1024, 1024, (1, 1)),
                                                     (1024, 1024, 1024, (4, 4))])
@pytest.mark.parametrize("K", [1, 2, 7, 16, 62])
def test_tile_plan_fits(M, R, C, tiles, K):
    """The plan's bytes fit a CTA, are the window's, k >= 1 and the
    launches run K cycles; a tile that fits one CTA is one launch."""
    Tr, Tc = R // tiles[0], C // tiles[1]
    plan = tile_plan(Tr, Tc, K)
    assert plan.k >= 1 and plan.smem <= sk.SMEM_LIMIT
    assert plan.smem == window_smem(Tr, Tc, plan.block, plan.k)
    assert plan.launches * plan.k >= K > (plan.launches - 1) * plan.k
    if window_smem(Tr, Tc, (Tr, Tc), 0) <= sk.SMEM_LIMIT:
        assert plan.block == (Tr, Tc) and plan.launches == 1
    else:
        assert plan.block == sk.PLAN_BLOCK and plan.k == min(K, sk.PLAN_K)


def test_tile_plan_at_full_width():
    """1024 x 1024: 64 x 64 blocks with an 8-cell halo (80 rows of 84
    slots, 176,000 B); every k of the sweep has a plan that fits, k = 1 too, and
    an oversized window halves its block."""
    plan = tile_plan(1024, 1024, 62)
    assert (plan.block, plan.k, plan.smem, plan.launches) == ((64, 64), 8, 176_000, 8)
    for k in (1, 2, 4, 8, 16):
        p = tile_plan(1024, 1024, 62, k=k)
        assert p.k == k and p.smem <= sk.SMEM_LIMIT and p.launches == -(-62 // k)
    assert tile_plan(1024, 1024, 62, k=16).block == (32, 64)
    with pytest.raises(ValueError):
        tile_plan(1024, 1024, 62, k=0)
    with pytest.raises(ValueError):
        tile_plan(1024, 1024, 62, k=200)
