"""Device and seed resolution shared by the engines.

Every engine and ``Simulation`` takes an explicit ``device``.  The default
is ``"cuda"``: without a CUDA device it raises instead of running on the
CPU quietly, so a caller who wants the CPU (the tests, a plain reference
run) says so with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent.  A sequence of devices (a sharded engine's, one a shard) gives
    a tuple of ``torch.device``, each checked: a ``cuda`` entry must name a
    card that is present, and none moves to the CPU quietly."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device sequence")
        return tuple(resolve_device(d) for d in device)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} is not present: this machine has "
                f"{torch.cuda.device_count()} CUDA device(s)"
            )
    return dev


def shard_devices(device, n: int) -> tuple:
    """The device of each of ``n`` shards, row-major over the real mesh
    axes: one device holds every shard, a sequence names one device a
    shard (the counterpart of a ``jax.sharding.Mesh``'s devices)."""
    devs = resolve_device(device)
    if isinstance(devs, torch.device):
        if devs.type == "cuda" and devs.index is None:
            devs = torch.device("cuda", torch.cuda.current_device())
        return (devs,) * n
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices given for {n} shards")
    return devs


def to_tensor(x, device) -> torch.Tensor:
    """``x`` (a tensor, numpy array or nested list) as a tensor on
    ``device``; numpy data is copied, so read-only arrays are safe."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def group_generator(key, group_index: int) -> torch.Generator:
    """The generator a block group's ``init_state`` draws from.

    ``key`` is an int seed or a ``torch.Generator``.  An int seeds one
    generator per group from (seed, group index), so groups draw
    independent streams and the result does not depend on group order; a
    generator is shared by the groups in order.
    """
    if isinstance(key, torch.Generator):
        return key
    seed = int(np.random.SeedSequence([int(key), int(group_index)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator().manual_seed(seed)
