"""manycore — the paper's own application (§IV-B), as in
``repro.configs.manycore``.

A 1024x1024 grid of message-passing cores, partitioned over 2 pods of
2x2 granules.  The sync rates are tiered: intra-pod boundaries exchange
every ``k_inner`` cycles, inter-pod boundaries every ``k_inner * k_outer``
— the paper's fast-shm/slow-TCP split.  ``WAFER`` is the smaller
flagship shape the JAX example runs on host CPUs.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ManycoreConfig:
    grid_rows: int = 1024
    grid_cols: int = 1024
    m_stream: int = 1024
    k_inner: int = 16          # intra-pod cycles per exchange (Fig. 15 knob)
    k_outer: int = 4           # inner rounds per inter-pod exchange
    pods: int = 2              # outer-tier (DCI) split of the grid rows
    queue_capacity: int = 62   # paper §III-B
    payload_words: int = 2

    @property
    def k_epoch(self) -> int:
        """The innermost sync rate."""
        return self.k_inner

    @property
    def pod_period(self) -> int:
        """Cycles between inter-pod synchronizations."""
        return self.k_inner * self.k_outer


CONFIG = ManycoreConfig()
SMOKE = ManycoreConfig(grid_rows=8, grid_cols=8, m_stream=8, k_inner=4,
                       k_outer=2, queue_capacity=8)
WAFER = ManycoreConfig(grid_rows=256, grid_cols=256, m_stream=0,
                       k_inner=8, k_outer=4, queue_capacity=8)
