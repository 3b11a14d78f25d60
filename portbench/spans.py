"""Device time charged to the program's own spans in a ``torch.profiler``
Chrome trace.

The port names parts of its step with ``record_function`` spans while a
profiler records (``sparse.spmv``, ``model.dense``, ``model.spectral``).
``device_us_by_span`` charges each piece of device work in the window
(kernel, copy, memset, cut to the window as ``traces.clip`` cuts it),
matched to its launch by the ``correlation`` id of the launching
``cuda_runtime``/``cuda_driver`` event, to at most one span of ``names``:

1. the innermost span of ``names`` open on the launching thread at the
   launch: the forward, and remat's replay of it inside the backward;
2. else, where the launch lies inside an autograd node's
   ``autograd::engine::evaluate_function: ...`` op, the innermost span of
   ``names`` that enclosed, on its own thread, the forward op that made
   the node: of the forward ops with the node's ``Sequence number`` on the
   thread its ``Fwd thread id`` names, the latest started before the node
   (an op peeks the sequence number and the op that makes a node takes
   it, so the ones started before it with that number made no node; the
   profiler links forward to backward by the same rule);
3. else nothing.

``Fwd thread id`` is the profiler's own number of a thread, not the
trace's ``tid``, and sequence numbers count per thread. The trace's
``fwdbwd`` flows, which the profiler draws from a forward op (``s``) to
its node's op (``f``), give the map from one to the other: each number
goes to the thread that most of its flows start on.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Optional

from portbench import traces

SPAN_NAMES = ("sparse.spmv", "model.dense", "model.spectral")
EVALUATE = "autograd::engine::evaluate_function: "
SPAN_CATEGORY = "user_annotation"


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def _interval(e: dict) -> tuple[float, float]:
    a = float(e["ts"])
    return a, a + float(e.get("dur", 0.0))


def _args(e: dict) -> dict:
    return e.get("args") or {}


def _innermost(intervals: dict, queries: dict) -> dict:
    """Per thread, for each query ``(t, qid)``, the payload of the innermost
    interval ``(a, b, payload)`` that holds ``t`` (``a <= t <= b``; the
    latest started of those open) → ``{qid: payload}``; queries that no
    interval holds are left out."""
    out = {}
    for key, qs in queries.items():
        points = []
        for i, (a, b, _) in enumerate(intervals.get(key, ())):
            points += [(a, 0, i), (b, 2, i)]
        points += [(t, 1, qid) for t, qid in qs]
        points.sort(key=lambda p: (p[0], p[1]))
        open_: list = []
        for _, kind, ref in points:
            if kind == 0:
                open_.append(ref)
            elif kind == 2:
                open_.remove(ref)
            elif open_:
                out[ref] = intervals[key][open_[-1]][2]
    return out


def _spans_by_thread(events: list[dict], names) -> dict:
    by = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == SPAN_CATEGORY and e.get("name") in names:
            by[_thread(e)].append((*_interval(e), e["name"]))
    return by


def forward_threads(events: list[dict]) -> dict:
    """``{Fwd thread id: (pid, tid)}`` from the ``fwdbwd`` flows."""
    back = {}  # (pid, tid, ts) of a node's op → its Fwd thread id
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            k = _args(e).get("Fwd thread id")
            if k:
                back[(*_thread(e), float(e["ts"]))] = k
    starts, ends = {}, {}
    for e in events:
        if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
            (starts if e["ph"] == "s" else ends)[e.get("id")] = e
    votes = defaultdict(Counter)
    for fid, f in ends.items():
        k = back.get((*_thread(f), float(f["ts"])))
        if k and fid in starts:
            votes[k][_thread(starts[fid])] += 1
    return {k: v.most_common(1)[0][0] for k, v in votes.items()}


def charges(events: list[dict], names, correlations) -> tuple[dict, dict]:
    """The span of ``names`` that each launch of ``correlations`` is
    charged to → ``({correlation: name}`` by rule 1, ``{correlation:
    name}`` by rule 2``)``; a launch charged to none is in neither."""
    launches = defaultdict(list)  # thread → [(ts, correlation)]
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in traces.LAUNCH_CATEGORIES:
            c = _args(e).get("correlation")
            if c in correlations:
                launches[_thread(e)].append((float(e["ts"]), c))
    spans = _spans_by_thread(events, names)
    direct = _innermost(spans, launches)

    nodes = defaultdict(list)  # thread → autograd nodes' evaluate ops
    forward = defaultdict(list)  # (pid, tid, sequence number) → forward op starts
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cpu_op":
            continue
        a = _args(e)
        seq = a.get("Sequence number")
        if seq is None:
            continue
        if e["name"].startswith(EVALUATE):
            nodes[_thread(e)].append((*_interval(e), (seq, a.get("Fwd thread id"),
                                                      float(e["ts"]))))
        elif not a.get("Fwd thread id"):
            forward[(*_thread(e), seq)].append(float(e["ts"]))
    rest = {k: [(t, c) for t, c in v if c not in direct] for k, v in launches.items()}
    in_node = _innermost(nodes, rest)
    threads = forward_threads(events) if in_node else {}
    for starts in forward.values():
        starts.sort()
    made_by = defaultdict(list)  # forward thread → [(forward op start, correlation)]
    for c, (seq, k, at) in in_node.items():
        where = threads.get(k)
        starts = forward.get((*where, seq), []) if where else []
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0:
            made_by[where].append((starts[i], c))
    return direct, _innermost(spans, made_by)


def device_us_by_span(events: list[dict], names, t0: float, t1: float) -> dict[str, float]:
    """µs of the device work inside ``[t0, t1]`` charged to each span of
    ``names`` by the rule above → ``{name: µs}`` (every name, 0 where
    nothing was charged)."""
    names = tuple(names)
    work: dict = defaultdict(float)
    for e in traces.clip(events, t0, t1):
        c = _args(e).get("correlation")
        if c is not None:
            work[c] += float(e["dur"])
    direct, via_node = charges(events, names, work)
    out = dict.fromkeys(names, 0.0)
    for c, name in (*direct.items(), *via_node.items()):
        out[name] += work[c]
    return out


def span_calls(events: list[dict], name: str, t0: float, t1: float) -> int:
    """The spans ``name`` that start inside ``[t0, t1]`` and lie inside no
    other span ``name`` on their thread."""
    count = 0
    for spans in _spans_by_thread(events, (name,)).values():
        end = float("-inf")
        for a, b, _ in sorted(spans, key=lambda s: (s[0], -s[1])):
            if a >= end:
                count += t0 <= a <= t1
                end = b
    return count


def window_charges(ctx) -> Optional[dict]:
    """``device_us_by_span`` of ``SPAN_NAMES`` over the traced window of
    ``ctx`` (``readers.Ctx``), worked out once a run; None where the card
    did not trace."""
    if ctx.events is None:
        return None
    got = getattr(ctx, "_span_us", None)
    if got is None:
        got = device_us_by_span(ctx.events, SPAN_NAMES, ctx.t0, ctx.t1)
        ctx._span_us = got
    return got
