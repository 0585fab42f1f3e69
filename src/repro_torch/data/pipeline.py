"""Deterministic synthetic LM data pipeline, as ``repro.data.pipeline``
(numpy only; the port keeps its own copy, batch for batch the same arrays).

Production-shaped: per-host sharding, document structure (EOS-delimited
spans so sequence packing is exercised), background prefetch, and a
checkpointable cursor (``state()`` / ``restore()``) so training resumes
bit-exactly after a failure (``runtime/fault_tolerance.py`` relies on it).

The token distribution is a fixed-seed Zipfian mixture, deterministic
given (seed, step, global batch row), so any restart on any host count
reproduces the same global stream (the stream is keyed by GLOBAL batch
row, not by host).  The trainer moves each batch to the device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    embed_dim: int | None = None  # set for embedding-input archs (vlm/audio)


class TokenPipeline:
    """Deterministic, shardable, checkpointable synthetic token stream."""

    def __init__(self, cfg: PipelineConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide n_hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self._step = 0

    # ---------------------------------------------------------------- state
    def state(self) -> dict:
        return {"step": self._step}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])

    # ---------------------------------------------------------------- batch
    def _row(self, step: int, global_row: int) -> np.ndarray:
        """One (seq_len + 1,) token row, deterministic in (seed, step, row)."""
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 4093 + global_row) % (2**31 - 1)
        )
        n = cfg.seq_len + 1
        out = np.empty(n, dtype=np.int32)
        pos = 0
        while pos < n:
            doc_len = max(int(rng.exponential(cfg.mean_doc_len)), 8)
            # Zipf-ish: squash uniform^3 toward frequent ids; id 0 = EOS/pad
            u = rng.rand(min(doc_len, n - pos))
            toks = (u**3 * (cfg.vocab - 2)).astype(np.int32) + 2
            out[pos : pos + len(toks)] = toks
            pos += len(toks)
            if pos < n:
                out[pos] = 1  # EOS
                pos += 1
        return out

    def batch(self, step: int | None = None) -> dict:
        """{'inputs': (local_batch, S) or (local_batch, S, D), 'labels': (local_batch, S)}."""
        if step is None:
            step = self._step
            self._step += 1
        cfg = self.cfg
        rows = np.stack(
            [
                self._row(step, self.host_id * self.local_batch + i)
                for i in range(self.local_batch)
            ]
        )
        labels = rows[:, 1:]
        if cfg.embed_dim is not None:
            # stub modality frontend: deterministic embeddings per token id
            rng = np.random.RandomState(cfg.seed + 17)
            table = rng.randn(256, cfg.embed_dim).astype(np.float32) * 0.02
            inputs = table[rows[:, :-1] % 256]
        else:
            inputs = rows[:, :-1]
        return {"inputs": inputs, "labels": labels}

    # ------------------------------------------------------------- prefetch
    def prefetch(self, depth: int = 2):
        """Iterator with a background producer thread (depth-bounded)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def producer():
            while not stop.is_set():
                b = self.batch()
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        class _Iter:
            def __iter__(self):
                return self

            def __next__(self):
                return q.get()

            def close(self):
                stop.set()

        return _Iter()
