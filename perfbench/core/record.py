"""What a driver hands back from one run, for the metric readers and the
result line."""
from __future__ import annotations

from dataclasses import dataclass, field

from .trace import Trace


@dataclass
class Record:
    unit: str                     # "pass" or "step": what the window repeats
    setup_s: float                # process start to the first timed unit
    window_s: float = 0.0         # the measured (or traced) window, host clock
    unit_walls: list = field(default_factory=list)   # each unit's wall, seconds
    samples: int = 0              # camera samples completed in the window
    peak_bytes: int = 0           # max_memory_allocated over the window
    trace: Trace | None = None    # with --trace 1
    spans: dict = field(default_factory=dict)        # name -> [seconds], traced runs
    numbers: dict = field(default_factory=dict)      # the compared numbers
    attempted: int = 0
    failed: int = 0

    @property
    def units(self) -> int:
        return len(self.unit_walls)
