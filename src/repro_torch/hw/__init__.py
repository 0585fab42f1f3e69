"""Hardware blocks of the port: the wafer's many-core cell and the
systolic MAC cell."""
from .manycore import CoreParams, CoreState, ManycoreCell
from .systolic import CellState, SystolicCell, SystolicParams, make_systolic_network, collect_result

__all__ = ["CellState", "CoreParams", "CoreState", "ManycoreCell", "SystolicCell",
           "SystolicParams", "collect_result", "make_systolic_network"]
