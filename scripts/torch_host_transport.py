#!/usr/bin/env python3
"""Host-side transport rates the procs engine depends on, on this machine.

The procs engine moves each worker's state between processes every epoch
of an until-run (the predicate's view) and at every gather/scatter.  This
script times, for one buffer of ``--mib`` MiB (the size of one worker's
queue array on the 1M wafer by default): numpy allocation and copies,
pickling, a ``multiprocessing`` pipe between two processes (raw bytes and
a pickled array), a POSIX shared-memory segment (first and second touch),
and device-to-host copies into fresh, warm, pinned and shared memory.
Prints one line a measurement, GB/s beside seconds.

    python3 scripts/torch_host_transport.py            # on the CUDA machine
    python3 scripts/torch_host_transport.py --mib 64 --no-cuda
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import pickle
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def timed(label: str, n: int, fn, reps: int = 2) -> None:
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        print(f"{label} #{i}: {dt:.4f} s ({n / dt / 1e9:.3f} GB/s)", flush=True)


def _child(conn, n: int) -> None:
    data = np.ones(n, np.uint8)
    conn.recv()
    conn.send_bytes(memoryview(data))
    conn.send(data)
    conn.recv()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=275)
    ap.add_argument("--no-cuda", action="store_true")
    args = ap.parse_args(argv)
    n = args.mib * 2**20
    from repro_torch.runtime.shmem import create_shared_memory

    timed("numpy allocate + fill (fresh pages)", n, lambda: np.ones(n, np.uint8))
    a = np.ones(n, np.uint8)
    timed("numpy copyto (warm pages)", n, lambda: np.copyto(a, 2))
    blob = pickle.dumps(a, protocol=5)
    timed("pickle.dumps", n, lambda: pickle.dumps(a, protocol=5))
    timed("pickle.loads", n, lambda: pickle.loads(blob))
    seg = create_shared_memory(f"transport{os.getpid()}", n)
    try:
        view = np.frombuffer(seg.buf, np.uint8)
        timed("shared memory copyto (first, then second touch)", n,
              lambda: np.copyto(view, 3))
        if not args.no_cuda:
            import torch

            x = torch.ones(n, dtype=torch.uint8, device="cuda")
            torch.cuda.synchronize()
            timed("device -> fresh pageable (.cpu())", n, lambda: x.cpu())
            warm = torch.zeros(n, dtype=torch.uint8)
            timed("device -> warm pageable", n, lambda: warm.copy_(x))
            pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            timed("device -> pinned", n, lambda: pinned.copy_(x))
            shm = torch.from_numpy(view)
            timed("device -> shared memory", n, lambda: shm.copy_(x))
            del shm
        del view
    finally:
        seg.close()
        seg.unlink()
    ctx = mp.get_context("forkserver")
    parent, child = ctx.Pipe()
    p = ctx.Process(target=_child, args=(child, n))
    p.start()
    parent.send("go")
    t0 = time.perf_counter()
    parent.recv_bytes()
    dt = time.perf_counter() - t0
    print(f"pipe recv_bytes: {dt:.4f} s ({n / dt / 1e9:.3f} GB/s)", flush=True)
    t0 = time.perf_counter()
    parent.recv()
    dt = time.perf_counter() - t0
    print(f"pipe recv (a pickled array): {dt:.4f} s ({n / dt / 1e9:.3f} GB/s)", flush=True)
    parent.send("bye")
    p.join(timeout=30)
    print(f"cpu count {os.cpu_count()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
