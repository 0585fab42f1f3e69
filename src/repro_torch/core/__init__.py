"""repro_torch.core — the simulator core in PyTorch.

The counterpart of ``repro.core``: Network description -> channel-graph IR
+ partition -> engine backend, with the same state layouts.

  struct      frozen dataclasses of tensors + tree-map helpers
  packet      SB packet layout (§III-A)
  queue       SPSC ring buffers, single-cycle + epoch bulk ops (§III-B)
  block       ready/valid Block protocol on a leading instance dim (§II-A)
  network     SbNetwork analogue; build(engine=...) and the NetworkSim oracle
  graph       channel-graph IR + PartitionTree shared by every backend
  distributed partition/tier/batch resolution, the batched exchange and
              the queue-interpreter GraphEngine (+ its GridEngine preset)
  fused       fused-epoch engine: depth-1 register channels + one resident
              epoch program (the Hopper kernel on CUDA)
  fastgrid    register engine: the systolic grid, one systolic_step call an
              epoch (the Hopper kernel on CUDA)
  session     Simulation facade: reset/run/probe/tx/rx/stats, monitors,
              trace, save/load and the legacy shims
  perfmodel   the §II-C measurement model and rate control (pure math)
"""
from .block import Block
from .network import Network, NetworkSim, NetworkState
from .graph import (
    ChannelGraph, PartitionLowering, PartitionTree, Tier, grid_partition,
    lower_partition, normalize_partition, normalize_tiers,
    tiered_grid_partition,
)
from .queue import QueueArray, make_queues, DEFAULT_CAPACITY
from .distributed import (
    GraphEngine, GraphState, GridEngine, edge_color_routes,
    granule_local_cycle, merge_compatible_classes,
)
from .fused import FusedEngine, FusedState
from .fastgrid import RegGridState, RegisterGridEngine
from .session import DonatedStateError, Monitor, RxPort, Simulation, TxPort
from . import packet
