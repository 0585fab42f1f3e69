"""Million-core experiment, scaled, on the PyTorch port (paper §IV-B).

Simulates a grid of systolic MAC cores computing Y = A @ B through
latency-insensitive queues — the paper's wafer-scale proof-of-concept —
on the queue interpreter's uniform-grid preset (``GridEngine``), and
shows:

  1. functional exactness against numpy,
  2. the paper's accuracy/rate trade-off: completion cycles against the
     epoch length K (the Fig. 15 phenomenon),
  3. the engine's throughput (cores x cycles / second).

With ``--tiles`` the grid is cut into tiles, one granule each, all
batched on one device; ``Y`` is the same bits at any tiling and any K.

    python examples/torch_systolic_matmul.py [--rows 16 --cols 16 --m 32]
    python examples/torch_systolic_matmul.py --tiles 2 2 --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import Simulation  # noqa: E402
from repro_torch.core.distributed import GridEngine  # noqa: E402
from repro_torch.hw.systolic import SystolicCell, make_cell_params  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--cols", type=int, default=16)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--tiles", type=int, nargs=2, default=(1, 1),
                    metavar=("DR", "DC"), help="granule tiles, batched on one device")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda)")
    args = ap.parse_args(argv)

    R, C, M = args.rows, args.cols, args.m
    rng = np.random.RandomState(0)
    A = rng.randn(M, R).astype(np.float32)
    B = rng.randn(R, C).astype(np.float32)
    Dr, Dc = args.tiles
    batch = {"gr": Dr, "gc": Dc} if (Dr, Dc) != (1, 1) else None
    print(f"grid {R}x{C} = {R * C} cores, streaming {M} rows of A, "
          f"{Dr}x{Dc} tiles on {args.device}")

    def done(cells):
        return ((~cells.is_south) | (cells.y_idx >= M)).all()

    ys = []
    print(f"{'K':>4} {'epochs':>7} {'cycles':>7} {'err':>10} {'wall_s':>7} {'core-cyc/s':>11}")
    for K in (1, 4, 16, 62):
        eng = GridEngine(SystolicCell(m_stream=M), R, C, K=K, batch_axes=batch,
                         device=args.device)
        sim = Simulation(eng).reset(0, cell_params=make_cell_params(A, B))
        t0 = time.perf_counter()
        sim.run(until=done, max_epochs=1_000_000, cache_key="done")
        sim.block_until_ready()
        wall = time.perf_counter() - t0
        cells = eng.gather_cells(sim.state)
        Y = cells.y_buf[R - 1, :, :].T
        ys.append(Y)
        err = np.abs(Y - A @ B).max()
        cycles, epochs = sim.cycle, sim.epoch
        rate = R * C * cycles / wall
        print(f"{K:4d} {epochs:7d} {cycles:7d} "
              f"{err:10.2e} {wall:7.2f} {rate:11.3e}")
    assert all(np.array_equal(y.view(np.uint32), ys[0].view(np.uint32)) for y in ys)
    print("\nY is the same bits for every K; on a tiled grid (--tiles) the")
    print("cycles grow with K — the paper's Fig. 15 accuracy/rate trade-off,")
    print("deterministically (one tile has no boundary to wait on).")


if __name__ == "__main__":
    main()
