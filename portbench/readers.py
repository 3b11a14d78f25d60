"""What the per-layer metric files read from.

A metric named ``<base>.<kind>`` in ``BENCHMARK.json`` is read by
``metrics/<base>.<kind>.py`` where that file exists, else by
``metrics/<base>.py``, one file for every kind (``train``, ``infer``,
``setup``). A metric file sets ``SOURCE`` and ``LAYER`` (as
``BENCHMARK.json`` has them), ``MOVES`` (the end-to-end metric of each
kind it reads) and ``read(ctx, kind) -> float | None``; None leaves the
metric out of the line, which is what a reader does where there is
nothing to read (a cell of another kind, a trace with no device work).
A share of a peak is never made up as 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from portbench import traces


@dataclasses.dataclass
class Ctx:
    kind: str  # "train" (a unit is an epoch) or "infer" (a unit is a pass)
    setup: dict  # the runner's ``setup`` event of ``metrics.jsonl``
    counts: dict  # counts/<family>.py of one unit: ``counts.Tally``'s fields
    units: int  # units in the traced window
    window_s: float  # the traced window on the host clock
    spectral: bool = False  # whether the model has Ritz pairs
    events: Optional[list] = None  # the window's Chrome trace, where the card traced
    t0: float = 0.0  # the window in trace time (µs)
    t1: float = 0.0

    @property
    def unit_s(self) -> float:
        return self.window_s / self.units

    def busy_s(self) -> Optional[float]:
        if self.events is None:
            return None
        return traces.busy_seconds(traces.clip(self.events, self.t0, self.t1))
