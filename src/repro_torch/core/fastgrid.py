"""Register-channel grid engine — the hand-specialized systolic preset, as
in ``repro.core.fastgrid``.

The engine runs the §IV-B systolic matmul grid:

  * intra-tile channels are **depth-1 elastic registers** (a valid/value
    pair per hop) — a legal latency-insensitive implementation, so the
    result equals the queue engines';
  * the whole K-cycle epoch of every tile runs in ONE call of
    ``kernels.systolic_step`` — on a CUDA state the hand-written Hopper
    kernel, on the CPU its plain PyTorch version;
  * tile boundaries are epoch slabs with credit flow control, as in the
    JAX engine.

The JAX engine puts one tile on each device of a ``(gr, gc)`` mesh and
moves the slabs with ``ppermute``.  Here a ``mesh`` does the same by a
single controller (``core.mesh``): each tile is a shard, its own state
on its own device, its epoch one ``systolic_step`` launch, and each
``pshift`` a copy from the sender shard's slab into the receiver's.  Or
``tiles=(Dr, Dc)`` keeps every tile on one device, stacked on the leading
``(Dr, Dc)`` dimensions of the state, and each ``ppermute`` is a shift
along a tile axis.  Either way a tile at the edge of the tile grid
receives zeros, as ``pshift`` gives it.  The state layout is the JAX
engine's (``repro_torch.convert`` carries it across; a sharded state
gathers to it).
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from ..kernels import systolic_step as sk
from ..obs import trace as _trace
from ..obs.registry import REGISTRY
from . import device_loop
from .device import resolve_device, shard_devices
from .graph import ChannelGraph
from .mesh import Placement, ShardedState, all_shards, require_one_card
from .struct import tensor_dataclass, tree_map


@tensor_dataclass
class RegGridState:
    """All leaves carry leading (Dr, Dc) tile dims."""

    cell: dict             # b, a_reg, a_v, p_reg, p_v, a_idx, y_idx, a_buf, y_buf, flags
    west_slab: torch.Tensor   # (Dr, Dc, Tr, 2K) ingress (east-bound data)
    west_cnt: torch.Tensor    # (Dr, Dc, Tr)
    north_slab: torch.Tensor  # (Dr, Dc, Tc, 2K)
    north_cnt: torch.Tensor   # (Dr, Dc, Tc)
    credit_e: torch.Tensor    # (Dr, Dc, Tr) packets we may send east next epoch
    credit_s: torch.Tensor    # (Dr, Dc, Tc)
    cycle: torch.Tensor       # (Dr, Dc)
    epoch: torch.Tensor       # (Dr, Dc)


def _compact(slab, cnt, consumed, arrived, arrived_cnt):
    """Drop ``consumed`` leading packets, append ``arrived``; per row.

    slab: (..., R, W); arrived: (..., R, A). Returns (slab', cnt').
    """
    W = slab.shape[-1]
    A = arrived.shape[-1]
    dev = slab.device
    idx = torch.arange(W, device=dev) + consumed[..., None].long()  # shift left
    shifted = torch.cat([slab, torch.zeros_like(slab)], -1).gather(-1, idx)
    left = cnt - consumed  # leftovers
    # insert arrived at position `left` per row
    pos = torch.arange(W, device=dev) - left[..., None].long()  # index into arrived
    can = (pos >= 0) & (pos < A) & (pos < arrived_cnt[..., None])
    from_arrived = arrived.gather(-1, pos.clamp(0, A - 1))
    new_slab = torch.where(can, from_arrived, shifted)
    return new_slab, left + torch.minimum(arrived_cnt, W - left)


def _shift(x: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """``x`` moved ``step`` (+1 or -1) along tile axis ``axis`` (0: rows,
    1: columns); the tiles the shift leaves empty get zeros."""
    out = torch.zeros_like(x)
    n = x.shape[axis]
    if n > 1:
        src = x.narrow(axis, 0, n - 1) if step > 0 else x.narrow(axis, 1, n - 1)
        out.narrow(axis, 1 if step > 0 else 0, n - 1).copy_(src)
    return out


class RegisterGridEngine(Placement):
    """The systolic register engine.

    R, C:     the grid of cells (rows of B, columns of B).
    K:        cycles per epoch (the sync rate between tiles).
    m_stream: rows of A streamed through the grid (M).
    tiles:    ``(Dr, Dc)`` tiles stacked on one device; R and C must divide.
    mesh:     ``None`` or ``{"gr": Dr, "gc": Dc}``: one tile a shard,
              each its own state on its own device (``core.mesh``), as
              the reference's mesh puts one on each device.  Pass
              ``tiles`` or a mesh, not both.
    device:   one device for every shard, or a sequence of ``Dr * Dc``
              devices, row-major.  ``"cuda"`` by default, and raises
              without CUDA (pass ``device="cpu"``).
    """

    engine_kind = "register"

    def __init__(self, R: int, C: int, K: int, m_stream: int, *,
                 tiles: tuple[int, int] = (1, 1),
                 mesh: Mapping[str, int] | None = None, device="cuda"):
        mesh = {str(a): int(s) for a, s in dict(mesh or {}).items()}
        extra = sorted(a for a, s in mesh.items() if a not in ("gr", "gc") and s > 1)
        if extra:
            raise ValueError(f"mesh axes {extra} are not the grid's ('gr', 'gc')")
        shards = (mesh.get("gr", 1), mesh.get("gc", 1))
        self._sharded = shards != (1, 1)
        if self._sharded and tuple(tiles) != (1, 1):
            raise ValueError(f"pass tiles={tuple(tiles)} or mesh={mesh}, not both")
        self.R, self.C = int(R), int(C)
        self.Dr, self.Dc = shards if self._sharded else (int(t) for t in tiles)
        if self.Dr < 1 or self.Dc < 1 or self.R % self.Dr or self.C % self.Dc:
            raise ValueError(f"grid {R}x{C} not divisible by tiles {(self.Dr, self.Dc)}")
        self.real_shape = (self.Dr, self.Dc) if self._sharded else (1, 1)
        self.devices = shard_devices(device, self.Dr * self.Dc if self._sharded else 1)
        # one shard: its device (a sequence of one is unwrapped)
        self.device = (self.devices[0] if self._sharded or isinstance(device, (list, tuple))
                       else resolve_device(device))
        self.Tr, self.Tc = self.R // self.Dr, self.C // self.Dc
        self.K = int(K)
        self.W = 2 * self.K  # ingress slab capacity (credit-bounded)
        self.M = int(m_stream)
        self.graph: ChannelGraph | None = None
        self._graph_ab: tuple[np.ndarray, np.ndarray] | None = None
        self._until_cache: dict = {}  # run_until's captured spans

    # ------------------------------------------------------- IR entry point
    @classmethod
    def from_graph(cls, graph: ChannelGraph, K: int, *,
                   tiles: tuple[int, int] = (1, 1),
                   mesh: Mapping[str, int] | None = None,
                   device="cuda") -> "RegisterGridEngine":
        """Build the register engine from the channel-graph IR.

        The kernel fuses the systolic-matmul cell semantics, so the IR must
        describe exactly the §IV-B topology — one group of ``SystolicCell``
        instances wired as a row-major R×C east/south grid with stacked
        ``SystolicParams``.  The shape is verified against a freshly
        generated reference grid IR; anything else raises ``ValueError``.
        """
        from ..hw.systolic import SystolicCell, SystolicParams

        if len(graph.groups) != 1 or not isinstance(graph.groups[0].block, SystolicCell):
            raise ValueError(
                "engine='register' requires a single-group SystolicCell "
                f"network, got {graph.summary()}"
            )
        grp = graph.groups[0]
        if not isinstance(grp.params, SystolicParams):
            raise ValueError("engine='register' requires stacked SystolicParams")
        is_north = np.asarray(grp.params.is_north).astype(bool).reshape(-1)
        C = int(is_north.sum())
        if C == 0 or grp.n_members % C:
            raise ValueError("engine='register' needs a rectangular systolic grid")
        R = grp.n_members // C
        ref = ChannelGraph.grid(
            grp.block, R, C,
            payload_words=graph.payload_words, dtype=graph.dtype,
            capacity=graph.capacity,
        )

        # Compare channel structure up to channel *renumbering*: every
        # channel is identified by its (src instance, dst instance) pair,
        # which is unique in a grid.  Sorting the pair keys of both graphs
        # matches each reference channel to the graph's channel.
        def endpoint_keys(g):
            n = np.int64(g.n_instances + 1)
            return g.chan_src[2:].astype(np.int64) * n + g.chan_dst[2:].astype(np.int64)

        ref_keys, act_keys = endpoint_keys(ref), endpoint_keys(graph)
        ref_order, act_order = np.argsort(ref_keys), np.argsort(act_keys)
        same = (
            not graph.ext_in and not graph.ext_out
            and graph.n_channels == ref.n_channels
            and np.array_equal(ref_keys[ref_order], act_keys[act_order])
        )
        if same:
            renum = np.arange(ref.n_channels, dtype=np.int64)
            renum[2 + ref_order] = 2 + act_order
            same = np.array_equal(renum[ref.rx_idx[0]], graph.rx_idx[0]) and (
                np.array_equal(renum[ref.tx_idx[0]], graph.tx_idx[0])
            )
        if not same:
            raise ValueError(
                "IR channel table is not the row-major east/south grid the "
                "register backend is specialized for"
            )
        a_buf = np.asarray(grp.params.a_buf)  # (R*C, M)
        M = a_buf.shape[-1]
        # west cells stream A[:, r]; copies, so the engine does not hold
        # the IR's (R, C, M) buffer
        A = np.array(a_buf.reshape(R, C, M)[:, 0, :].T, np.float32)
        B = np.array(grp.params.b, np.float32).reshape(R, C)
        eng = cls(R, C, K=K, m_stream=M, tiles=tiles, mesh=mesh, device=device)
        eng.graph = graph
        eng._graph_ab = (A, B)
        return eng

    # ------------------------------------------------------------------ init
    def _tile(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, ...) -> (Dr, Dc, Tr, Tc, ...), contiguous."""
        Dr, Dc, Tr, Tc = self.Dr, self.Dc, self.Tr, self.Tc
        x = x.reshape((Dr, Tr, Dc, Tc) + tuple(x.shape[2:]))
        return x.permute((0, 2, 1, 3) + tuple(range(4, x.dim()))).contiguous()

    def init(self, A: np.ndarray | None = None,
             B: np.ndarray | None = None) -> RegGridState:
        """The initial state for ``Y = A @ B`` (A: (M, R), B: (R, C)); an
        engine built from the IR takes its operands from there.  The
        (R, C, M) stream buffer is made on the device: only its west column
        holds A.  A sharded engine's state is a ``core.mesh.ShardedState``
        (see :meth:`place`)."""
        if A is None and B is None and self._graph_ab is not None:
            A, B = self._graph_ab
        if A is None or B is None:
            raise ValueError("init needs A and B (or an engine built from the IR)")
        R, C, M = self.R, self.C, self.M
        Dr, Dc, Tr, Tc = self.Dr, self.Dc, self.Tr, self.Tc
        A = np.asarray(A, np.float32)
        B = np.asarray(B, np.float32)
        if A.shape != (M, R) or B.shape != (R, C):
            raise ValueError(f"A {A.shape} / B {B.shape} do not match "
                             f"M={M}, R={R}, C={C}")
        dev = self.device
        lead = (Dr, Dc, Tr, Tc)
        rr = torch.arange(R, device=dev)[:, None].expand(R, C)
        cc = torch.arange(C, device=dev)[None, :].expand(R, C)
        a_buf = torch.zeros((Dr, Dc, Tr, Tc, M), dtype=torch.float32, device=dev)
        # west cells (global column 0: tile column 0, local column 0)
        a_buf[:, 0, :, 0, :] = torch.from_numpy(
            np.ascontiguousarray(A.T)).to(dev).reshape(Dr, Tr, M)
        zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)  # noqa: E731
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)  # noqa: E731
        cell = dict(
            b=self._tile(torch.from_numpy(B).to(dev)),
            a_reg=zf(*lead), a_v=zb(*lead),
            p_reg=zf(*lead), p_v=zb(*lead),
            a_idx=zi(*lead), y_idx=zi(*lead),
            a_buf=a_buf, y_buf=zf(*lead, M),
            is_west=self._tile(cc == 0),
            is_north=self._tile(rr == 0),
            is_south=self._tile(rr == R - 1),
            is_east=self._tile(cc == C - 1),
        )
        return self.place(RegGridState(
            cell=cell,
            west_slab=zf(Dr, Dc, Tr, self.W), west_cnt=zi(Dr, Dc, Tr),
            north_slab=zf(Dr, Dc, Tc, self.W), north_cnt=zi(Dr, Dc, Tc),
            credit_e=torch.full((Dr, Dc, Tr), self.W, dtype=torch.int32, device=dev),
            credit_s=torch.full((Dr, Dc, Tc), self.W, dtype=torch.int32, device=dev),
            cycle=zi(Dr, Dc), epoch=zi(Dr, Dc),
        ))

    @property
    def cycles_per_epoch(self) -> int:
        return self.K

    # ----------------------------------------------------------------- epoch
    def step_input(self, st: RegGridState) -> dict:
        """The dict an epoch's ``systolic_step`` call takes: the cells, the
        ingress slabs, and emission limits of the credits capped at K."""
        K = self.K
        return dict(
            st.cell,
            west_slab=st.west_slab, west_cnt=st.west_cnt,
            north_slab=st.north_slab, north_cnt=st.north_cnt,
            east_limit=torch.clamp(st.credit_e, max=K),
            south_limit=torch.clamp(st.credit_s, max=K),
        )

    def _pshift(self, xs: list, axis: int, step: int) -> list:
        """Each tile's ``xs`` entry moved ``step`` (+1 or -1) along tile
        axis ``axis`` (0: rows, 1: columns): the reference's ``pshift``.
        Stacked tiles shift within their tensor; on a mesh the receiving
        shard gets a copy of its sender's tensor.  A tile the shift leaves
        empty gets zeros."""
        if not self._sharded:
            return [_shift(xs[0], axis, step)]
        out = []
        for r, x in enumerate(xs):
            i, j = divmod(r, self.Dc)
            si, sj = (i - step, j) if axis == 0 else (i, j - step)
            if 0 <= si < self.Dr and 0 <= sj < self.Dc:
                out.append(torch.empty_like(x).copy_(xs[si * self.Dc + sj]))
            else:
                out.append(torch.zeros_like(x))
        return out

    def _epoch_all(self, sts, step: Callable | None = None,
                   stop: torch.Tensor | None = None) -> tuple:
        """One epoch of every tile, ``sts`` one state a shard: ``step``
        (``systolic_step`` unless a caller holds a version against
        another) runs each shard's K cycles, then the slabs and credits
        move one tile east/south (west/north for credits).  On a CUDA
        state the kernel updates the cell tensors in place.  Where
        ``stop`` (the until-loop's () bool tensor) is set, the step, the
        exchange and the counters leave the state as it was
        (``torch.where`` on the slab, count and credit leaves: no host
        read); a gated epoch bumps no registry counter."""
        step = sk.systolic_step if step is None else step
        outs = [step(self.step_input(st), self.K) if stop is None
                else step(self.step_input(st), self.K, stop) for st in sts]

        # emission was credit-bounded inside the kernel; send everything
        slab_e_in = self._pshift([o["east_slab"] for o in outs], 1, +1)
        cnt_e_in = self._pshift([o["east_cnt"] for o in outs], 1, +1)
        slab_s_in = self._pshift([o["south_slab"] for o in outs], 0, +1)
        cnt_s_in = self._pshift([o["south_cnt"] for o in outs], 0, +1)
        west, north = [], []
        for r, out in enumerate(outs):
            west.append(_compact(out["west_slab"], out["west_cnt"], out["widx"],
                                 slab_e_in[r], cnt_e_in[r]))
            north.append(_compact(out["north_slab"], out["north_cnt"], out["nidx"],
                                  slab_s_in[r], cnt_s_in[r]))
        credit_e = self._pshift([self.W - w[1] for w in west], 1, -1)
        credit_s = self._pshift([self.W - n[1] for n in north], 0, -1)
        if stop is None:  # the until-loop counts its own epochs
            REGISTRY.inc("register.dispatch.count")
            REGISTRY.inc("register.epochs")
        new_sts = []
        for r, (st, out) in enumerate(zip(sts, outs)):
            new = dict(west_slab=west[r][0], west_cnt=west[r][1],
                       north_slab=north[r][0], north_cnt=north[r][1],
                       credit_e=credit_e[r], credit_s=credit_s[r])
            if stop is None:
                run = 1
            else:
                new = {k: torch.where(stop, getattr(st, k), v) for k, v in new.items()}
                run = (~stop).to(st.epoch.dtype)
            new_sts.append(st.replace(
                cell={k: out[k] for k in st.cell}, **new,
                cycle=st.cycle + self.K * run, epoch=st.epoch + run,
            ))
        return tuple(new_sts)

    def _epoch(self, st: RegGridState, step: Callable | None = None,
               stop: torch.Tensor | None = None) -> RegGridState:
        """One epoch of an unsharded engine's state (see ``_epoch_all``)."""
        return self._epoch_all((st,), step, stop)[0]

    # ------------------------------------------------------------------- run
    def _owned(self, state, donate: bool):
        """The state a run may update, placed: the CUDA path updates the
        cell tensors in place, so a caller who keeps its input
        (``donate=False``) gets a copy run instead."""
        if self._sharded and not isinstance(state, ShardedState):
            return self.place(state)  # a copy on the shards already
        if donate or self.device.type == "cpu":
            return state
        return tree_map(lambda x: x.clone(), state)

    def run_epochs(self, state, n_epochs: int, *, donate: bool = True):
        """Advance ``n_epochs`` epochs (K cycles each).

        ``donate=True`` (default) lets the CUDA kernel update the state's
        tensors in place: the *input* state must not be reused afterwards.
        Pass ``donate=False`` to keep the input alive."""
        sts = self._shards(self._owned(state, donate))
        for _ in range(n_epochs):
            sts = self._epoch_all(sts)
        return self._join(sts)

    def tiles_done(self, cell: dict, done_fn: Callable) -> torch.Tensor:
        """() bool on the cells' device: ``done_fn`` holds on every tile's
        local cell dict (leaves (Tr, Tc, ...)) of one state's stacked
        tiles, the view ``run_until``'s predicate gets — each tile's result
        stacked and reduced, as the reference's ``vmap(done_fn)(...).all()``,
        with no host read."""
        Dr, Dc = cell["b"].shape[:2]
        return torch.stack([
            device_loop.flag(done_fn({k: v[dr, dc] for k, v in cell.items()}),
                             cell["b"].device)
            for dr in range(Dr) for dc in range(Dc)
        ]).all()

    def _done_all(self, sts, done_fn: Callable) -> torch.Tensor:
        """() bool: ``done_fn`` holds on every tile of every shard, reduced
        on each shard's device and then over the shards (the reference's
        ``psum`` of not-done)."""
        return all_shards([self.tiles_done(st.cell, done_fn) for st in sts])

    def host_done(self, state, done_fn: Callable) -> bool:
        """``done_fn`` read on the host, on the view ``run_until`` shows it."""
        return bool(self._done_all(self._shards(state), done_fn))

    def run_until(self, state, done_fn: Callable, max_epochs: int, *,
                  cache_key=None, donate: bool = True):
        """Run epochs until ``done_fn(cell)`` holds on every tile (the
        predicate sees the tile-local cell dict), or at most ``max_epochs``
        MORE epochs from the input state (a relative budget).  The predicate
        is checked before every epoch, so an already-done state runs zero
        epochs.  The loop runs on the device, cached and keyed as
        ``GraphEngine.run_until``'s (``core.device_loop``): the predicate
        must return a device tensor without reading it back.  Shards on
        several cards raise ``NotImplementedError``, as there."""
        require_one_card(self.devices)
        return device_loop.run_until(
            self._until_cache, self._owned(state, donate),
            enter=self._shards, leave=self._join,
            epoch=lambda sts, stop: self._epoch_all(sts, stop=stop),
            done=lambda sts: self._done_all(sts, done_fn),
            max_epochs=max_epochs, donate=donate,
            anchor=done_fn if cache_key is None else cache_key,
        )

    def run_until_host(self, state, done_fn: Callable, max_epochs: int, *,
                       donate: bool = True):
        """The plain version of :meth:`run_until`: the predicate read back
        on the host before every epoch (``device_loop.host_loop``)."""
        return device_loop.host_loop(
            self._owned(state, donate),
            enter=self._shards, leave=self._join,
            epoch=lambda sts, stop: self._epoch_all(sts, stop=stop),
            done=lambda sts: self._done_all(sts, done_fn),
            max_epochs=max_epochs,
        )

    def run_until_done(self, state, max_epochs: int, *, donate: bool = True):
        """Run epochs until every south cell collected all M outputs."""
        return self.run_until(state, self.y_done, max_epochs,
                              cache_key="y_done", donate=donate)

    def y_done(self, cell: dict) -> torch.Tensor:
        """() bool — every south cell of ``cell`` collected all M outputs."""
        return ((~cell["is_south"]) | (cell["y_idx"] >= self.M)).all()

    # -------------------------------------------------------- host utilities
    def group_state(self, state, inst) -> dict:
        """One cell's (unstacked) state leaves — the probe surface
        (``Simulation.probe``).  ``inst`` is the row-major instance id of
        the cell (or an ``Instance``), the IR numbering of the same grid."""
        inst_id = inst if isinstance(inst, int) else inst.inst_id
        r, c = divmod(int(inst_id), self.C)
        tile, cell = (r // self.Tr, c // self.Tc), (r % self.Tr, c % self.Tc)
        if self._sharded:
            st = self._shards(state)[tile[0] * self.Dc + tile[1]]
            tile = (0, 0)
        else:
            st = state
        return {k: v[tile + cell] for k, v in st.cell.items()}

    def result(self, state) -> np.ndarray:
        """Y (M, C) from the south-edge cells (only their y_buf is copied
        to the host); traced as a ``session.read`` span."""
        with _trace.recorder().session_span("session.read", api="result"):
            if self._sharded:
                shards = self._shards(state)[(self.Dr - 1) * self.Dc:]
                y = torch.cat([st.cell["y_buf"][0, 0, self.Tr - 1].cpu()
                               for st in shards])
            else:
                y = state.cell["y_buf"][self.Dr - 1, :, self.Tr - 1]  # (Dc, Tc, M)
            return y.reshape(self.C, self.M).T.cpu().numpy()

    def port_stats(self, state: RegGridState) -> dict:
        """The register engine has no external ports."""
        return {"tx": {}, "rx": {}}


__all__ = ["RegGridState", "RegisterGridEngine"]
