"""Inputs from the seed: one generator a run, on the run's device."""
from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, run: int, device) -> torch.Generator:
    """The generator of run ``run`` (-1: the warm run of set-up) under
    ``seed``: the same pair gives the same draws on every machine with the
    same device type.  Seeds may exceed 32 bits."""
    if seed < 0 or run < -1:
        raise ValueError(f"seed {seed} and run {run} must be non-negative (run -1: warm)")
    state = np.random.SeedSequence([int(seed), int(run) + 1]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g
