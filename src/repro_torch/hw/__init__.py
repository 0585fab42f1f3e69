"""Hardware blocks of the port: the wafer's many-core cell, the systolic
MAC cell and the pipeline stage."""
from .manycore import CoreParams, CoreState, ManycoreCell
from .pipestage import PipeStage, PipeStageState, make_chain, make_ring
from .systolic import CellState, SystolicCell, SystolicParams, make_systolic_network, collect_result

__all__ = ["CellState", "CoreParams", "CoreState", "ManycoreCell", "PipeStage",
           "PipeStageState", "SystolicCell", "SystolicParams", "collect_result",
           "make_chain", "make_ring", "make_systolic_network"]
