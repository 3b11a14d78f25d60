"""Profiling and tracing.

Counterpart of ``lanczosnet_tpu/utils/profiling.py``, in PyTorch's idiom:

- ``trace``: a ``torch.profiler`` capture (the CPU, and the card where
  there is one) exported as a Chrome trace into a directory (``trace/``
  in the run directory under ``train.profile: true``);
- ``debug_nans``: scoped ``torch.autograd.set_detect_anomaly``, which
  raises where a backward produces NaN;
- ``program_cost``: the floating-point operations one call does, from
  ``torch.utils.flop_counter.FlopCounterMode`` (what torch cannot count,
  such as the bytes a program moves, is left out, as the JAX function
  drops what its backend lacks);
- ``device_busy_seconds``: the union of the card's kernel intervals in
  an exported trace, or None where it holds none (the CPU);
- ``StepTimer``: wall time over device work, the device synchronized
  before the clock is read.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import torch

TRACE_FILE = "trace.json"
# Chrome-trace categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_active: list[Path] = []


@contextlib.contextmanager
def trace(log_dir: str | Path | None) -> Iterator[None]:
    """Capture a trace into ``log_dir/trace.json`` (a no-op for None). A
    trace opened inside another marks its span in the outer one (one
    profiler runs at a time) and leaves ``log_dir`` empty."""
    if log_dir is None:
        yield
        return
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    if _active:
        with torch.profiler.record_function(f"trace:{log_dir}"):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _active.append(log_dir)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(str(log_dir / TRACE_FILE))
    finally:
        _active.pop()


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Scoped anomaly detection: a backward that produces NaN raises."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(bool(enable))
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def program_cost(fn, *args: Any, **kwargs: Any) -> dict:
    """``{"flops": n}`` for one call of ``fn(*args, **kwargs)``, counted by
    ``FlopCounterMode`` as it runs (matrix products and convolutions,
    forward and backward; a kernel launched through ``ctypes`` is not
    seen). The call runs for real: pass the step that is due anyway."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def device_busy_seconds(trace_dir: str | Path) -> Optional[float]:
    """Seconds the card was busy in ``trace_dir/trace.json``: the union of
    the intervals of its kernels, copies and memsets, so that overlapping
    streams count once. None where the trace is missing or holds no
    device work (a trace taken on the CPU)."""
    path = Path(trace_dir) / TRACE_FILE
    if not path.exists():
        return None
    events = json.loads(path.read_text()).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return busy_us / 1e6


def _sync_result(result: Any) -> None:
    tensors = result if isinstance(result, (list, tuple)) else [result]
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


class StepTimer:
    """Wall time over device work: ``start()``, then ``stop(x)`` with ``x``
    an output (or a sequence of outputs) of the timed work, whose card is
    synchronized before the clock is read."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.total = 0.0
        self.count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result: Any = None) -> float:
        _sync_result(result)
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
