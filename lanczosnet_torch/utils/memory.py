"""The memory figures the runners and the probes log."""

from __future__ import annotations

import resource
from typing import Callable

import torch


def host_peak_rss_mb() -> float:
    """This process's peak resident set on the host, MB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def peak_memory(fn: Callable[[], object], device: torch.device, track=()) -> dict:
    """Run ``fn`` once → ``{"peak_allocated_bytes", "peak_reserved_bytes",
    "source"}``. On the card: the caching allocator's peaks over the call
    (``reset_peak_memory_stats``, ``max_memory_allocated`` and
    ``max_memory_reserved``), whatever was allocated before the call
    included. On the CPU: the peak of the live tensors ``MemTracker``
    follows through the call, the modules, optimizers and tensors in
    ``track`` (made before the call) among them; the CPU has no caching
    allocator, so nothing is reserved beyond them."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize(device)
        return {"peak_allocated_bytes": int(torch.cuda.max_memory_allocated(device)),
                "peak_reserved_bytes": int(torch.cuda.max_memory_reserved(device)),
                "source": "torch.cuda"}
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    tracker.track_external(*track)
    with tracker:
        fn()
    peak = sum(int(v["Total"]) for v in tracker.get_tracker_snapshot("peak").values())
    return {"peak_allocated_bytes": peak, "peak_reserved_bytes": peak,
            "source": "MemTracker (live tensors)"}
