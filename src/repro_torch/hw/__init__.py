"""Hardware blocks of the port (the wafer's many-core cell)."""
from .manycore import CoreParams, CoreState, ManycoreCell

__all__ = ["CoreParams", "CoreState", "ManycoreCell"]
