"""The host's memory figures the runners log."""

from __future__ import annotations

import resource


def host_peak_rss_mb() -> float:
    """This process's peak resident set on the host, MB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
