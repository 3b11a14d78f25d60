"""Reading a ``torch.profiler`` Chrome trace.

``busy_seconds`` and ``op_self_times`` are frozen copies of the port's
``lanczosnet_torch/utils/profiling.py`` arithmetic (device busy time as
the union of kernel, copy and memset intervals; each instant charged to
the innermost op open then), kept here so that a
change to the program cannot move the yardstick. Added for the
benchmark: the measured window's bounds, the launches and device time
of kernels by name, the calls of named ATen ops, the top device ops, and
idle gaps named by the harness span in which the host launched the work
that ended them.
"""

from __future__ import annotations

import bisect
import json
import re
from pathlib import Path
from typing import Optional

# Chrome-trace categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def load_trace(path: str | Path) -> list[dict]:
    """The events of a Chrome trace file."""
    return json.loads(Path(path).read_text()).get("traceEvents", [])


def _spans(events: list[dict], categories) -> list[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in categories]


def busy_seconds(events: list[dict]) -> Optional[float]:
    """The union of the intervals of the card's kernels, copies and
    memsets, so that overlapping streams count once; None where there
    are none."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in _spans(events, DEVICE_CATEGORIES))
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return busy_us / 1e6


def op_self_times(events: list[dict], categories=DEVICE_CATEGORIES) -> dict[tuple[str, str], dict]:
    """``{(name, cat): {"self_us", "count"}}`` over the complete events
    (``ph`` X) of ``categories``: every instant covered by some event is
    charged to the innermost one open then (the latest started), so an
    outer op's self time excludes its children and the self times sum to
    the union of the intervals, overlapping streams counted once."""
    spans = _spans(events, categories)
    points = []
    for i, e in enumerate(spans):
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if t1 > t0:  # ends first at a tie; the outer op opens first
            points += [(t0, 1, -t1, i), (t1, 0, 0.0, i)]
    points.sort()
    out: dict[tuple[str, str], dict] = {}
    for e in spans:
        out.setdefault((e["name"], e["cat"]), {"self_us": 0.0, "count": 0})["count"] += 1
    open_: list[int] = []
    last = None
    for t, starts, _, i in points:
        if open_ and last is not None and t > last:
            e = spans[open_[-1]]
            out[(e["name"], e["cat"])]["self_us"] += t - last
        last = t
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
    return out


def window(events: list[dict], name: str) -> tuple[float, float]:
    """``(t0, t1)`` in µs of the host span ``name`` (a ``record_function``)."""
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == name:
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
    raise LookupError(f"no span {name!r} in the trace")


def clip(events: list[dict], t0: float, t1: float, categories=DEVICE_CATEGORIES) -> list[dict]:
    """The events of ``categories`` cut to ``[t0, t1]``."""
    out = []
    for e in _spans(events, categories):
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append({**e, "ts": a, "dur": b - a})
    return out


def kernels_named(events: list[dict], parts, t0: float, t1: float) -> tuple[int, float]:
    """``(launches, µs)`` of the kernels inside ``[t0, t1]`` (cut to it as
    ``clip`` cuts them) whose name holds one of the strings ``parts``."""
    hits = [e for e in clip(events, t0, t1, ("kernel",)) if any(p in e["name"] for p in parts)]
    return len(hits), sum(float(e["dur"]) for e in hits)


def outermost_calls(events: list[dict], ops, t0: float, t1: float) -> dict[str, int]:
    """Per op of ``ops``, its host calls that start inside ``[t0, t1]`` and
    lie inside no other call of ``ops`` on their thread."""
    ops = tuple(ops)
    by_thread: dict = {}
    for e in _spans(events, ("cpu_op",)):
        if e["name"] in ops:
            a = float(e["ts"])
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                (a, -float(e.get("dur", 0.0)), e["name"]))
    out = dict.fromkeys(ops, 0)
    for calls in by_thread.values():
        end = float("-inf")
        for a, neg_dur, name in sorted(calls):
            if a >= end:
                if t0 <= a <= t1:
                    out[name] += 1
                end = a - neg_dur
    return out


def short_name(name: str, width: int = 64) -> str:
    """A kernel's name cut to ``width`` characters, runs of anything but
    letters, digits and ``_`` made one ``_``."""
    return re.sub(r"[^A-Za-z0-9_]+", "_", name)[:width]


def top_device_ops(events: list[dict], t0: float, t1: float, count: int = 10) -> list:
    """``[[name, seconds], ...]``: the device ops with the most self time
    inside the window, by name."""
    by_name: dict[str, float] = {}
    for (name, _), rec in op_self_times(clip(events, t0, t1)).items():
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + rec["self_us"] / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:count]]


def idle_gaps(events: list[dict], t0: float, t1: float, span_names, count: int = 10) -> list:
    """``[[name, seconds], ...]``: the window's device idle time, each gap
    charged to the harness span (of ``span_names``) open on the host when
    the gap ended, i.e. while the host launched the work that ended it;
    ``outside_the_harness_s_spans`` where none was."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in clip(events, t0, t1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in _spans(events, ("user_annotation",)) if e.get("name") in span_names)
    gaps, end = [], t0
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    starts = [h[0] for h in host]
    out: dict[str, float] = {}
    for a, b in gaps:
        name = "outside_the_harness_s_spans"
        i = bisect.bisect_right(starts, b) - 1
        if i >= 0 and b <= host[i][1]:
            name = host[i][2]
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:count]]
