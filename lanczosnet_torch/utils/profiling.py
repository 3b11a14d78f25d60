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
- ``op_self_times`` and ``self_time_table``: each op's self time in an
  exported trace (its children's excluded) and the sums by category
  (GEMM, the two Lanczos kernels, eigh, elementwise, reductions,
  copies, ...), the counterpart of ``load_xspace`` and
  ``scripts/profile_step.py:analyze``;
- ``span``: a named span of the program's own (a ``record_function``)
  while a profiler records, and nothing otherwise;
- ``qm8_train_flops_per_graph``: the analytic FLOPs of a LanczosNet
  training step a graph, the numerator of the flagship's MFU against
  ``FP32_FLOPS_PER_S``.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Any, Iterator, Optional

import torch

TRACE_FILE = "trace.json"
# H100 SXM data sheet (at the 700 W limit): float32 outside the tensor
# cores, the rate the flagship's MFU is reckoned against (TF32 off)
FP32_FLOPS_PER_S = 67e12
# Chrome-trace categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_active: list[Path] = []
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str | Path | None, host: bool = True) -> Iterator[None]:
    """Capture a trace into ``log_dir/trace.json`` (a no-op for None). A
    trace opened inside another marks its span in the outer one (one
    profiler runs at a time) and leaves ``log_dir`` empty. ``host=False``
    records the card's timeline alone (its kernels, copies and the
    runtime calls that launched them) and none of the host's ops, which
    over hundreds of steps would make a trace of hundreds of MB; without a
    card the host's ops are recorded."""
    if log_dir is None:
        yield
        return
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    if _active:
        with torch.profiler.record_function(f"trace:{log_dir}"):
            yield
        return
    activities = []
    if host or not torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CPU)
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


def span(name: str):
    """A context naming the work inside it ``name`` in a trace: a
    ``record_function`` while a ``torch.profiler`` capture records (on
    this thread, or on autograd's thread that inherits it), else one
    shared null context, so that untraced runs pay an attribute read
    and one call. The card's kernels launched inside it, and those of
    the backward of its ops, are charged to it by the trace's readers."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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


def load_trace(path: str | Path) -> list[dict]:
    """The events of a Chrome trace: ``path`` is the JSON file or the
    directory ``trace`` wrote it into."""
    path = Path(path)
    if path.is_dir():
        path = path / TRACE_FILE
    return json.loads(path.read_text()).get("traceEvents", [])


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


def device_busy_seconds(trace_dir: str | Path) -> Optional[float]:
    """Seconds the card was busy in ``trace_dir/trace.json``
    (``busy_seconds``). None where the trace is missing or holds no
    device work (a trace taken on the CPU)."""
    path = Path(trace_dir) / TRACE_FILE
    return busy_seconds(load_trace(path)) if path.exists() else None


def op_self_times(events: list[dict], categories=DEVICE_CATEGORIES) -> dict[tuple[str, str], dict]:
    """``{(name, cat): {"self_us", "count"}}`` over the complete events
    (``ph`` X) of ``categories``: every instant covered by some event is
    charged to the innermost one open then (the latest started), so an
    outer op's self time excludes its children and the self times sum to
    the union of the intervals, overlapping streams counted once. The
    JAX script rebuilds the same nesting from ``[offset, offset+dur)``."""
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


# (category, substrings of the lower-cased op name): the first match
# wins; the card's kernels by their names, the host's ops (a trace taken
# on the CPU) by their aten names; copies and memsets on the card also
# by their trace category
OP_CATEGORIES = (
    ("B1 lanczos_tridiag", ("lanczos_tridiag",)),
    ("B2 lanczos_stream", ("lanczos_stream",)),
    ("eigh", ("syev", "stedc", "steqr", "sytrd", "ormtr", "orgtr", "larf", "cusolver",
              "jacobi", "eigh")),
    ("GEMM", ("gemm", "gemv", "cutlass", "xmma", "matmul", "dot_kernel", "aten::mm",
              "aten::bmm", "addmm", "baddbmm")),
    ("copies", ("copy", "catarray", "memcpy", "memset", "fill", "clone", "aten::cat")),
    ("gathers and scatters", ("index", "gather", "scatter")),
    ("reductions", ("reduce", "softmax", "norm", "argmax", "sort", "scan", "aten::sum",
                    "aten::mean", "aten::max", "aten::min")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply", "_foreach")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "aten::add", "aten::sub",
                     "aten::mul", "aten::div", "aten::abs", "aten::neg", "aten::lerp",
                     "aten::sqrt", "aten::tanh", "aten::relu", "aten::exp", "aten::where",
                     "aten::pow", "aten::sign", "aten::dropout", "aten::bernoulli")),
)


def op_category(name: str, cat: str = "kernel") -> str:
    """The row of ``self_time_table`` an op falls in ("other" if none)."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copies"
    low = name.lower()
    for category, keys in OP_CATEGORIES:
        if any(k in low for k in keys):
            return category
    return "other"


def self_time_table(self_times: dict[tuple[str, str], dict]) -> list[dict]:
    """``op_self_times``'s result by ``op_category``, largest first:
    ``[{"category", "self_ms", "share", "ops", "kinds"}]`` (``ops``:
    events; ``kinds``: distinct op names)."""
    rows: dict[str, dict] = {}
    for (name, cat), rec in self_times.items():
        row = rows.setdefault(op_category(name, cat),
                              {"self_ms": 0.0, "ops": 0, "kinds": 0})
        row["self_ms"] += rec["self_us"] / 1e3
        row["ops"] += rec["count"]
        row["kinds"] += 1
    total = sum(r["self_ms"] for r in rows.values()) or 1.0
    return [{"category": c, **r, "share": r["self_ms"] / total}
            for c, r in sorted(rows.items(), key=lambda kv: -kv[1]["self_ms"])]


def qm8_train_flops_per_graph(hidden, n, k, short, long_, edge_types, tasks, filter_hidden) -> float:
    """Model FLOPs of one training step per graph (the analytic count of
    ``bench.py:analytic_train_flops_per_graph``): 2 FLOPs a multiply-add
    in the forward, times 3 for forward and backward; padding waste not
    counted. At the flagship (hidden 128×3, N=32, K=20, short [1,2,3],
    long [5,7,10,20,30], 4 edge types, 16 tasks, filter width 16) a
    layer has 3·32²·128 (short chain) + 20·32·128 + 32·20·5·128 (VᵀX
    and the long scales) + 5·20·48 (filter MLPs) + 4·32²·128 (edge
    hops) + 32·(128·13)·128 (the layer's Dense) = 8,229,568 multiply-adds;
    three layers and the readout's 32·128·17 give a forward of
    49,516,672 FLOPs, and a step 148,550,016 FLOPs a graph."""
    f = hidden[0]
    parts = 1 + len(short) + len(long_) + edge_types
    macs = 0.0
    for dim in hidden:
        macs += max(short) * n * n * f
        macs += k * n * f + n * k * len(long_) * f
        macs += len(long_) * k * (2 * filter_hidden + filter_hidden)
        macs += edge_types * n * n * f
        macs += n * (f * parts) * dim
        f = dim
    macs += n * f * (tasks + 1)
    return 3.0 * 2.0 * macs
