"""Checks of the ``systolic_step`` kernel against its plain version, both
on the card, shared by ``tests/test_torch_kernel.py`` and
``chip_smoke.py``.  Each check raises ``AssertionError`` on a mismatch and
needs a CUDA device."""
from __future__ import annotations

import numpy as np
import torch

from ..core.struct import tree_map_with_path, tree_paths
from ..hw.systolic import mac, matmul_error_bound
from . import systolic_step as sk


def clone_state(st):
    """A copy of a register engine state that the kernel may overwrite; the
    read-only stream buffer ``a_buf`` (4 GiB at full width) is shared."""
    return tree_map_with_path(
        lambda path, x: x if path == "cell.a_buf" else x.clone(), st)


def assert_states_equal(a, b) -> float:
    """Max |a - b| over every leaf of two register engine states on the
    card; raises unless every leaf is bit-exact (floats compared as bits)."""
    la, lb = dict(tree_paths(a)), dict(tree_paths(b))
    if sorted(la) != sorted(lb):
        raise AssertionError(f"leaf sets differ: {sorted(la)} vs {sorted(lb)}")
    worst, bad = 0.0, []
    for k, x in la.items():
        y = lb[k]
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


def check_mac(n: int, seed: int) -> int:
    """The kernel's ``__fmaf_rn`` MAC against ``hw.systolic.mac`` on the card
    and on the CPU (an exact FMA there) on ``n`` standard-normal triples,
    bit for bit.  Returns how many of them multiply-then-add rounds
    differently (raises if none: the check would guard nothing)."""
    rng = np.random.RandomState(seed)
    p, a, b = (torch.from_numpy(rng.randn(n).astype(np.float32)) for _ in range(3))
    kern = sk.mac_cuda(p.cuda(), a.cuda(), b.cuda()).cpu()
    plain_card = mac(p.cuda(), a.cuda(), b.cuda()).cpu()
    plain_cpu = mac(p, a, b)
    two = int((kern != p + a * b).sum())
    bad = [name for name, x in (("mac on the card", plain_card),
                                ("mac on the CPU", plain_cpu))
           if not torch.equal(kern.view(torch.int32), x.view(torch.int32))]
    if bad or two == 0:
        raise AssertionError(f"the kernel's FMA differs from {bad} (or from no "
                             f"two-rounding result: {two})")
    return two


def check_engine(M: int, R: int, C: int, K: int, tiles: tuple[int, int],
                 seed: int, plan: sk.TilePlan | None = None) -> tuple[int, int]:
    """The register engine's epochs through the kernel (under ``plan``,
    ``tile_plan``'s by default) and through the plain version, both on the
    card, from ``A``, ``B`` drawn from ``seed``: every state leaf equal
    after every epoch, through completion, one kernel call an epoch, and
    ``Y`` within ``matmul_error_bound`` of the f64 product.  Returns
    (epochs, cycles)."""
    from ..core.fastgrid import RegisterGridEngine

    rng = np.random.RandomState(seed)
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    eng = RegisterGridEngine(R, C, K=K, m_stream=M, tiles=tiles, device="cuda")
    gpu = eng.init(A, B)
    plain = clone_state(gpu)
    step = lambda s, k: sk.systolic_step_cuda(s, k, plan)  # noqa: E731
    before = sk.launches
    epochs = 0
    while not eng.tiles_done(gpu.cell, eng.y_done):
        if epochs > 4 * (2 * M + R + C):
            raise AssertionError(f"{(M, R, C)} K={K} tiles={tiles} did not finish")
        gpu = eng._epoch(gpu, step=step)
        plain = eng._epoch(plain, step=sk.systolic_step_ref)
        torch.cuda.synchronize()
        assert_states_equal(gpu, plain)
        epochs += 1
    if epochs == 0 or sk.launches - before != epochs:
        raise AssertionError(f"{sk.launches - before} launches for {epochs} epochs")
    err = np.abs(eng.result(gpu).astype(np.float64) - A.astype(np.float64) @ B)
    if not (err <= matmul_error_bound(A, B)).all():
        raise AssertionError(f"{(M, R, C)} K={K} tiles={tiles}: Y off the f64 "
                             f"product by {err.max()}")
    return epochs, int(gpu.cycle.reshape(-1)[0])


def check_call(state: dict, K: int, plan: sk.TilePlan | None = None,
               want: dict | None = None) -> None:
    """One ``K``-cycle kernel call under ``plan`` on a copy of ``state``
    against the plain version's call on the same state (``want``, computed
    here unless given), both on the card: every output key bit-equal."""
    if want is None:
        want = sk.systolic_step_ref(dict(state), K)
    got = sk.systolic_step_cuda(
        {k: v if k == "a_buf" else v.clone() for k, v in state.items()}, K, plan)
    torch.cuda.synchronize()
    keys = sk.CELL_OUT + sk.EDGE_OUT
    assert_states_equal({k: got[k] for k in keys}, {k: want[k] for k in keys})


def check_interior_tile(limits: tuple[int, int] | None, seed: int = 1,
                        calls: int = 4) -> int:
    """A 5x7 interior tile (no edge flags, M = 6, K = 8) fed only through
    its west and north slabs, with east/south emission ``limits`` (the slab
    width when None): every output key of the kernel equal to the plain
    version's, call by call, no emission above its limit.  Returns the
    packets emitted (raises if none)."""
    M, R, C, K = 6, 5, 7, 8
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to(dev)
    z = lambda dt, *shape: torch.zeros(shape or (R, C), dtype=dt, device=dev)  # noqa: E731
    full = lambda n, v: torch.full((n,), v, dtype=torch.int32, device=dev)  # noqa: E731
    st = dict(
        b=f(R, C), a_reg=z(torch.float32), a_v=z(torch.bool),
        p_reg=z(torch.float32), p_v=z(torch.bool), a_idx=z(torch.int32),
        y_idx=z(torch.int32), a_buf=z(torch.float32, R, C, M),
        y_buf=z(torch.float32, R, C, M), is_west=z(torch.bool),
        is_north=z(torch.bool), is_south=z(torch.bool), is_east=z(torch.bool),
        west_slab=f(R, 2 * K), west_cnt=full(R, 5),
        north_slab=f(C, 2 * K), north_cnt=full(C, 6),
    )
    e_max, s_max = limits or (2 * K, 2 * K)
    if limits is not None:
        st.update(east_limit=full(R, e_max), south_limit=full(C, s_max))
    emitted = 0
    for call in range(calls):
        want = sk.systolic_step_ref(dict(st), K)
        got = sk.systolic_step_cuda({k: v.clone() for k, v in st.items()}, K)
        torch.cuda.synchronize()
        for k in sk.CELL_OUT + sk.EDGE_OUT:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"interior tile, call {call}: {k} differs")
        if int(got["east_cnt"].max()) > e_max or int(got["south_cnt"].max()) > s_max:
            raise AssertionError(f"interior tile, call {call}: emission above "
                                 f"its limit {(e_max, s_max)}")
        emitted += int(got["east_cnt"].sum() + got["south_cnt"].sum())
        st.update({k: got[k] for k in sk.CELL_OUT})
    if emitted == 0:
        raise AssertionError("the interior tile emitted nothing")
    return emitted


__all__ = ["assert_states_equal", "check_call", "check_engine",
           "check_interior_tile", "check_mac", "clone_state"]
