"""Systolic matrix-multiply core grid — the million-core experiment (paper
§IV-B), as in ``repro.hw.systolic``.

A 1024×1024 grid of cores computes ``Y = A @ B``: each core stores one
element of B, A-elements stream in from the west and move east, partial
sums flow north→south, rows of Y appear at the south edge (paper Fig. 12).
The unit cell is a latency-insensitive MAC core:

    fire  = a_valid & psum_valid & east_ready & south_ready
    on fire: emit a eastward, emit (psum + a*b) southward

Ordering is enforced entirely by handshakes, so there is no wavefront skew
logic.  Edge behaviour is folded into the cell via per-instance flags so
the grid is uniform (one block type, one step over every instance):

  * ``is_west``:  synthesize the A stream from a local buffer;
  * ``is_north``: synthesize ``psum = 0`` (always valid);
  * ``is_south``: collect outputs into a local result buffer (always ready);
  * ``is_east``:  drop the eastward output (always ready).

Packet payload: 2 words — [value, tag], the tag being the A-row index.

**The MAC is a fused multiply-add.**  XLA contracts the reference's
``psum + a_val * b`` into one FMA (a single rounding), so every MAC of the
port goes through :func:`mac`; a separate multiply and add would round
twice and drift from the reference.  ``kernels/csrc/systolic_step.cu``
writes the same MAC as ``__fmaf_rn``, and so does the fused engine's
device step of this cell in ``kernels/csrc/granule_step.cu``; any change
to :meth:`SystolicCell.step` must be made there too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block
from ..core.network import Network
from ..core.struct import tensor_dataclass, tree_map

PAYLOAD_WORDS = 2  # [value, tag]

#: The state leaves the fused engine's device step takes, with their dtypes
#: (``a_buf`` and ``y_buf`` are ``(n, M)``, the rest ``(n,)``), and those
#: other threads read within a cycle: the producer of a west cell's
#: ``n_in`` reads its ``a_idx`` (its ``a_valid``), so the kernel keeps two
#: buffers of it, by cycle parity.
DEVICE_LEAVES = {
    "b": torch.float32, "is_west": torch.bool, "is_north": torch.bool,
    "is_south": torch.bool, "is_east": torch.bool, "a_buf": torch.float32,
    "a_idx": torch.int32, "y_buf": torch.float32, "y_idx": torch.int32,
    "fires": torch.int32,
}
PAIRED_LEAVES = ("a_idx",)


def mac(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``p + a * b`` rounded once (a fused multiply-add), elementwise."""
    return torch.addcmul(p, a, b)


@tensor_dataclass
class CellState:
    b: torch.Tensor         # (n,) f32 stationary B element
    is_west: torch.Tensor   # (n,) bool
    is_north: torch.Tensor
    is_south: torch.Tensor
    is_east: torch.Tensor
    a_buf: torch.Tensor     # (n, M) A-stream source (west cells), zeros elsewhere
    a_idx: torch.Tensor     # (n,) int32 next stream element
    y_buf: torch.Tensor     # (n, M) collected outputs (south cells)
    y_idx: torch.Tensor     # (n,) int32
    fires: torch.Tensor     # (n,) int32 — handshake counter (perf stats)


@tensor_dataclass
class SystolicParams:
    """Per-instance parameters, stacked by the network builder."""

    b: torch.Tensor
    is_west: torch.Tensor
    is_north: torch.Tensor
    is_south: torch.Tensor
    is_east: torch.Tensor
    a_buf: torch.Tensor  # (M,) per instance


class SystolicCell(Block):
    in_ports = ("w_in", "n_in")
    out_ports = ("e_out", "s_out")
    payload_words = PAYLOAD_WORDS

    def __init__(self, m_stream: int):
        self.m_stream = int(m_stream)  # #A-rows streamed through the array

    def init_state(self, n: int, params: SystolicParams | None = None, *,
                   generator=None, device=None) -> CellState:
        """The cell draws no random numbers, so ``generator`` is unused."""
        if params is None:
            raise ValueError("SystolicCell requires per-instance params")
        p = tree_map(lambda x: torch.as_tensor(x, device=device), params)
        dev = p.b.device
        zi = torch.zeros((n,), dtype=torch.int32, device=dev)
        return CellState(
            b=p.b.to(torch.float32).reshape(n).clone(),
            is_west=p.is_west.to(torch.bool).reshape(n).clone(),
            is_north=p.is_north.to(torch.bool).reshape(n).clone(),
            is_south=p.is_south.to(torch.bool).reshape(n).clone(),
            is_east=p.is_east.to(torch.bool).reshape(n).clone(),
            a_buf=p.a_buf.to(torch.float32).reshape(n, self.m_stream).clone(),
            a_idx=zi.clone(),
            y_buf=torch.zeros((n, self.m_stream), dtype=torch.float32, device=dev),
            y_idx=zi.clone(),
            fires=zi.clone(),
        )

    def step(self, state: CellState, rx, tx_ready):
        return self._step(state, rx, tx_ready)

    def step_(self, state: CellState, rx, tx_ready, enable=None):
        """:meth:`step` for an engine that owns ``state`` and updates it in
        place (``distributed.granule_local_cycle`` on the card): ``y_buf``,
        (n, M), takes each collected output where it lies instead of being
        copied every cycle.  ``enable`` (a () bool tensor, or None) gates
        that write as the engine gates the other leaves; the returned state
        holds ``state.y_buf`` itself.  The same bits as :meth:`step`."""
        return self._step(state, rx, tx_ready, inplace=True, enable=enable)

    def _step(self, state: CellState, rx, tx_ready, inplace=False, enable=None):
        (w_pay, w_valid) = rx["w_in"]
        (n_pay, n_valid) = rx["n_in"]
        e_ready = tx_ready["e_out"]
        s_ready = tx_ready["s_out"]
        M = self.m_stream

        # Effective inputs after edge synthesis.
        stream_left = state.a_idx < M
        src = state.a_buf.gather(1, (state.a_idx % M).long()[:, None])[:, 0]
        a_val = torch.where(state.is_west, src, w_pay[:, 0])
        a_tag = torch.where(state.is_west, state.a_idx.to(torch.float32), w_pay[:, 1])
        a_valid = torch.where(state.is_west, stream_left, w_valid)
        psum = torch.where(state.is_north, torch.zeros_like(n_pay[:, 0]), n_pay[:, 0])
        psum_valid = state.is_north | n_valid

        e_rdy = state.is_east | e_ready
        s_rdy = state.is_south | s_ready

        fire = a_valid & psum_valid & e_rdy & s_rdy
        y = mac(psum, a_val, state.b)

        # Handshakes back to queues (only for non-synthesized ports).
        rx_ready = {
            "w_in": fire & ~state.is_west,
            "n_in": fire & ~state.is_north,
        }
        tx = {
            "e_out": (torch.stack([a_val, a_tag], dim=1), fire & ~state.is_east),
            "s_out": (torch.stack([y, a_tag], dim=1), fire & ~state.is_south),
        }

        collect = fire & state.is_south
        slot = (state.y_idx % M).long()[:, None]
        if inplace:
            write = collect if enable is None else collect & enable
            rows = torch.arange(slot.shape[0], device=slot.device)
            held = state.y_buf[rows, slot[:, 0]]
            state.y_buf[rows, slot[:, 0]] = torch.where(write, y, held)
            y_buf = state.y_buf
        else:
            y_buf = torch.where(collect[:, None],
                                state.y_buf.scatter(1, slot, y[:, None]), state.y_buf)
        new_state = state.replace(
            a_idx=state.a_idx + (fire & state.is_west).to(torch.int32),
            y_buf=y_buf,
            y_idx=state.y_idx + collect.to(torch.int32),
            fires=state.fires + fire.to(torch.int32),
        )
        return new_state, rx_ready, tx


def make_cell_params(a: np.ndarray, b: np.ndarray) -> SystolicParams:
    """Stacked per-cell params for grid (rows=K, cols=N) computing A@B.

    a: (M, K) — streamed west→east (core row r carries A[:, r]).
    b: (K, N) — stationary (core (r, c) holds B[r, c]).
    Returns params with leading dims (K, N), as numpy arrays: an engine
    places them on its device.
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"A is (M, {k}) but B is ({k2}, N)")
    rr, cc = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    a_buf = np.zeros((k, n, m), np.float32)
    a_buf[:, 0, :] = a.T  # west-edge cells stream A[:, r]
    return SystolicParams(
        b=b, is_west=cc == 0, is_north=rr == 0, is_south=rr == k - 1,
        is_east=cc == n - 1, a_buf=a_buf,
    )


def make_systolic_network(a: np.ndarray, b: np.ndarray,
                          capacity: int = 8) -> tuple[Network, list]:
    """Build a single-netlist Network for Y = A @ B.

    Returns (network, grid_of_instances).  ``ChannelGraph.grid`` with
    ``params=make_cell_params(a, b)`` gives the same IR without a Python
    loop per instance (the route at full width).
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    m, k = a.shape
    _, n = b.shape
    params = make_cell_params(a, b)
    cell = SystolicCell(m_stream=m)
    net = Network(payload_words=PAYLOAD_WORDS, capacity=capacity)
    grid = [
        [
            net.instantiate(cell, name=f"c{r}_{c}",
                            params=tree_map(lambda x: x[r, c], params))
            for c in range(n)
        ]
        for r in range(k)
    ]
    for r in range(k):
        for c in range(n):
            if c + 1 < n:
                net.connect(grid[r][c]["e_out"], grid[r][c + 1]["w_in"])
            if r + 1 < k:
                net.connect(grid[r][c]["s_out"], grid[r + 1][c]["n_in"])
    return net, grid


def collect_result(sim, state, grid) -> np.ndarray:
    """Read Y (M, N) out of the south-edge cells' y_buf."""
    k = len(grid)
    n = len(grid[0])
    cols = [sim.group_state(state, grid[k - 1][c]).y_buf.cpu().numpy()
            for c in range(n)]
    return np.stack(cols, axis=1)  # (M, N)


def matmul_error_bound(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise bound on ``|Y - A @ B|`` for the grid's ``Y``, against
    the exact product.  Column c of Y sums its R products in row order with
    one rounding a MAC (a fused multiply-add), so the error is at most
    gamma_R * (|A| @ |B|), gamma_R = R*u / (1 - R*u) and u = 2^-24 (the
    standard bound for a recursive sum); a relative 1e-12 more covers the
    f64 product the caller holds Y against."""
    a = np.abs(np.asarray(a, np.float64))
    b = np.abs(np.asarray(b, np.float64))
    R = a.shape[1]
    u = 2.0**-24
    return (R * u / (1 - R * u)) * (a @ b) * (1 + 1e-12)


def cycles_needed(m: int, k: int, n: int) -> int:
    """Loose upper bound on cycles for the single-netlist run to finish."""
    return 4 * (m + k + n) + 64
