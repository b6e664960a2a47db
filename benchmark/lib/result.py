"""What one run hands back to ``run.py``: the end-to-end values, the
numbers of the check, and what the per-layer readers read."""

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Context:
    config: dict
    family: object         # the config's reference (registry.family)
    traffic: dict
    check: dict            # checks/<cell>.json: the comparison's parameters
    seed: int
    seconds: float
    trace: bool
    devices: list          # the cards the cell asks for
    root: str              # the checkout
    tmp: str               # the run's scratch directory
    t_start: float         # perf_counter at process start (set-up's start)
    control: Optional[str] = None


@dataclass
class Result:
    attempted: int
    failed: int
    e2e: dict                                  # end-to-end name -> value
    numbers: dict                              # the check's numbers
    layer: dict = field(default_factory=dict)  # counters the readers read
    spans: object = None                       # lib.spans.Spans when traced
    trace: object = None                       # lib.trace.TraceSummary
    cards: list = field(default_factory=list)  # trace card ids, in order
    memory_peak_bytes: int = 0
