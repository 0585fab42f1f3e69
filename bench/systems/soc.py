"""The §IV-A heterogeneous SoC at scale (``configs/soc-1M.json``) as the
benchmark drives it: ``n_socs`` SoCs, each a ``Cpu``, a ``DramModel`` and
an ``AnalogRamp``, whole SoCs a granule on ``granules`` granules batched
on one card, built by the port's public path (``hw.soc.soc_graph``,
``ChannelGraph.replicate``, and the engine's constructor), wrapped as a
``Simulation`` and run to ``soc_done``: every CPU has retired its reads.

A run draws every DRAM's contents on the device from the seed and the
run's index (whole numbers ``contents.low`` to ``contents.high``), hands
them to ``Simulation.reset`` and reads the CPU group back
(``gather_group``): every CPU's ``n_req`` results.  The reference
(``reference/soc_ref.py``) gets the same contents.

The results of a run are ``n_socs * n_req`` words (32 MiB at full size)
and the window holds thousands of runs, too many to keep.  So each run's
words, as the timed read brought them to the host, are reduced to a
digest (:func:`digest`: a sum of every word's bits times a random odd
weight of the seed, modulo 2**32, which any single wrong word changes).
On the card the read's page-locked words are copied back and digested on
a stream of their own, queued after the read and never waited for inside
it: the timed read is the program's, and the copy overlaps the next
reset.  The digests stay on the card until the window ends.  The first
run's words are kept whole too.  The check compares each run's digest
with the reference's and counts the differing words where they were
kept.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import epoch_count
from ..inputs import generator
from ..reference import soc_ref

#: A small size of the configuration, for runs of the cell on the card in
#: tests (``bench/test_bench_card.py``, through ``bench/conftest.py``).
SMALL = dict(n_socs=8192, granules=8, max_epochs=100)


def contents(cfg: dict, seed: int, run: int, device) -> torch.Tensor:
    """(n_socs, n_req) float32 DRAM contents of run ``run``, SoC-major."""
    lo, hi = cfg["contents"]["low"], cfg["contents"]["high"]
    g = generator(seed, run, device)
    return torch.randint(lo, hi + 1, (cfg["n_socs"], cfg["n_req"]), generator=g,
                         device=device, dtype=torch.int32).to(torch.float32)


def weights(cfg: dict, seed: int, device) -> torch.Tensor:
    """The digest's weights under ``seed``: one odd int64 below 2**31 a
    result word, drawn on the host apart from every run's contents."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x50C]))
    n = cfg["n_socs"] * cfg["n_req"]
    w = rng.integers(0, 2**30, n, dtype=np.int64) * 2 + 1
    return torch.from_numpy(w).to(device)


def digest(words: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """() int64 on the words' device, not read back: the sum of every
    float32 word's bits times its weight, modulo 2**32.  A word that
    differs changes it (an odd weight times a nonzero difference is
    nonzero modulo 2**32); several cancel with odds of about 2**-31."""
    bits = words.reshape(-1).contiguous().view(torch.int32).to(torch.int64)
    bits &= 0xFFFFFFFF
    bits *= w.to(bits.device)
    bits &= 0xFFFFFFFF
    return bits.sum() & 0xFFFFFFFF


def answer(run: int, words: torch.Tensor, w: torch.Tensor) -> dict:
    """What a run hands the check: the digest of its ``words`` and, for the
    first run, the words themselves."""
    return {"digest": digest(words, w), "shape": tuple(words.shape),
            "words": words.cpu().numpy().copy() if run == 0 else None}


class System:
    """N SoCs on the engine the traffic mix names."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from repro_torch.core import Simulation
        from repro_torch.core.distributed import GraphEngine
        from repro_torch.core.fused import FusedEngine
        from repro_torch.hw import soc

        engines = {"fused": FusedEngine, "graph": GraphEngine}
        if mix["engine"] not in engines:
            raise ValueError(f"the SoC runs on {sorted(engines)}, not {mix['engine']!r}")
        fixed = {"n_req": soc.N_REQ, "dram_latency": soc.DramModel.LATENCY,
                 "ramp_period": soc.AnalogRamp.PERIOD,
                 "clock_divider": soc.AnalogRamp.clock_divider}
        for key, value in fixed.items():
            if cfg[key] != value:
                raise ValueError(f"{key} is {value} in the port's SoC, {cfg[key]} here")
        n, G = cfg["n_socs"], cfg["granules"]
        self.cfg, self.seed, self.device = cfg, seed, device
        self.cores = 3 * n  # blocks
        self.engine = engines[mix["engine"]](
            soc.soc_graph(n, cfg["queue_capacity"]), soc.soc_partition(n, G), None,
            K=cfg["k"], batch_axes={"g": G}, overlap=False, device=device)
        self.sim = Simulation(self.engine)
        self._params = soc.DramParams
        self._run = -1
        self._w = weights(cfg, seed, device)
        # the check's copy and digest of each read, beside the next run
        self._side = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._held = None  # the last read's words, until its copy is done
        # one predicate object for every run: the device loop's captured
        # span is cached under it
        self.done = lambda s: soc.soc_done(s.block_states[0], s.tables.active[0])  # noqa: E731

    def reset(self, run: int) -> None:
        self._run = run
        mem = contents(self.cfg, self.seed, run, self.device)
        self.sim.reset(0, group_params={1: self._params(mem=mem)})

    def run(self) -> None:
        self.sim.run(until=self.done, max_epochs=self.cfg["max_epochs"])

    @property
    def cycle(self) -> int:
        return self.sim.cycle

    def readback(self) -> dict:
        """Every CPU's results read back in SoC order (the CPU group read
        whole).  Then, for the check, the digest of the words the read
        brought to the host, queued on the side stream (the next run's
        reset waits for the card, and so for it, before its next read)."""
        host = self.engine.gather_group(self.sim.state, 0).results
        words = torch.from_numpy(host)
        out = {"digest": None, "shape": tuple(host.shape),
               "words": host.copy() if self._run == 0 else None}
        if self._side is None:
            out["digest"] = digest(words, self._w)
            return out
        self._held = host
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            out["digest"] = digest(words.to(self.device, non_blocking=True), self._w)
        return out

    def close(self) -> None:
        if self._side is not None:
            self._side.synchronize()
        self.sim = self.engine = self.done = self._held = None


def ref_args(cfg: dict, mix: dict) -> dict:
    return dict(n_req=cfg["n_req"], latency=cfg["dram_latency"],
                period=cfg["ramp_period"], divider=cfg["clock_divider"], k=cfg["k"],
                capacity=cfg["queue_capacity"], intra=mix["intra_channel"],
                max_epochs=cfg["max_epochs"])


def reference_schedule(cfg: dict, mix: dict, device) -> tuple:
    """The reference's (addr, sample, stop) of the configuration's SoCs."""
    return soc_ref.schedule(cfg["n_socs"], device=device, **ref_args(cfg, mix))


class Check:
    """Of a run: the CPU result words that differ from the reference's
    (counted where the run's words were kept; elsewhere 0 where the digests
    agree and every word where they do not), and how far its stop cycle
    and the cycle after its reset lie from the reference's."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.addr, self.sample, self.stop = reference_schedule(cfg, mix, device)
        self.w = weights(cfg, seed, device)

    def __call__(self, run: int, out, rec: dict) -> dict:
        if out["digest"] is None:
            raise ValueError(f"run {run}'s words have no digest")
        mem = contents(self.cfg, self.seed, run, self.device)
        want = soc_ref.results(mem, self.addr, self.sample)
        if tuple(out["shape"]) != tuple(want.shape):
            raise ValueError(f"results are {tuple(out['shape'])}, "
                             f"the reference's {tuple(want.shape)}")
        mismatch = 0 if int(digest(want, self.w)) == int(out["digest"]) else want.numel()
        if out["words"] is not None:  # the words read to the host, counted
            ref = np.ascontiguousarray(want.cpu().numpy(), np.float32)
            counted = np.count_nonzero(out["words"].view(np.uint32) != ref.view(np.uint32))
            mismatch = max(counted, 1) if mismatch else counted
        return {"result_mismatch": float(mismatch),
                "stop_cycle_diff": float(abs(rec["cycles"] - self.stop)),
                "start_cycle": float(abs(rec["start_cycle"]))}


def control_output(cfg: dict, mix: dict, seed: int, run: int, device) -> tuple:
    """The control's answer and record: the reference's results in
    bfloat16 in the program's place, stopping where the reference stops."""
    addr, sample, stop = reference_schedule(cfg, mix, device)
    words = soc_ref.results_bf16(contents(cfg, seed, run, device), addr, sample)
    return answer(run, words, weights(cfg, seed, device)), {"start_cycle": 0, "cycles": stop}


def run_bytes(cfg: dict, cycles: int) -> float:
    """The per-epoch count of one run of ``cycles`` cycles: every SoC's
    modelled state read and written once an epoch (no event crosses an
    exchange)."""
    return epoch_count(cfg, cfg["n_socs"], {}, cycles)
