"""What a driver hands back about its window, for the readers and the
result line."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .spans import Units
from .trace import Trace


@dataclasses.dataclass
class Record:
    cfg: dict                  # the configuration file
    traffic: dict              # the traffic file
    training: bool
    atom_fdim: int
    bond_fdim: int
    num_tasks: int
    units: Units
    window_s: float            # host seconds from the first unit to the end
    end_to_end: Dict[str, float]
    checks: Dict[str, dict]    # name -> {"value", "limit"}
    correct: bool
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Trace] = None
