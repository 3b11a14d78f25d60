#!/usr/bin/env python3
"""Per-op profile of the flagship's training program on the card.

Counterpart of ``scripts/profile_step.py``. It traces the program that
script traces, the flagship LanczosNet's device-resident training
epochs at the bench's working point (batch 64, N=32, K=20, hidden
128×3, short [1, 2, 3], long [5, 7, 10, 20, 30], 21,760 graphs), with
``torch.profiler`` through ``lanczosnet_torch/utils/profiling.py:trace``.
The trace also holds the pack that precomputes the Ritz pairs (the
shared-memory Lanczos kernel and the eigh), which the port runs on the
card before the epochs. It prints a markdown table of **self** device
time by op category (``utils/profiling.py:self_time_table``: an op's
children excluded, overlapping streams counted once), the device-busy
time, and graphs/s and MFU (148.55 MFLOP a graph against 67 TFLOP/s,
float32 outside the tensor cores) for the traced epochs and for one more
epoch without the profiler. The last line is one JSON object.

Run from the repository's root:

    python3 scripts/torch_profile_step.py               # on the card
    python3 scripts/torch_profile_step.py --batch 128
    python3 scripts/torch_profile_step.py --device cpu  # host ops only
    python3 scripts/torch_profile_step.py --parse-only exp/torch_profile_step/trace.json

``--parse-only`` reads a saved Chrome trace and needs no card. The trace
is written to ``exp/torch_profile_step/trace.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from lanczosnet_torch.data.dataset import pack_dataset  # noqa: E402
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs  # noqa: E402
from lanczosnet_torch.models import build_model  # noqa: E402
from lanczosnet_torch.train.optim import build_optimizer  # noqa: E402
from lanczosnet_torch.train.scan_epoch import (  # noqa: E402
    device_dataset,
    device_permutation,
    train_epoch,
)
from lanczosnet_torch.train.step import make_train_step  # noqa: E402
from lanczosnet_torch.utils.device import resolve_device  # noqa: E402
from lanczosnet_torch.utils.profiling import (  # noqa: E402
    FP32_FLOPS_PER_S,
    busy_seconds,
    load_trace,
    op_self_times,
    qm8_train_flops_per_graph,
    self_time_table,
    trace,
)
# the working point, defined once for the port's tools
from torch_bench import (  # noqa: E402
    BATCH,
    EDGE_TYPES,
    FILTER_HIDDEN,
    HID,
    K,
    LONG,
    N,
    NUM_GRAPHS,
    SHORT,
    TASKS,
    model_config,
)

EPOCHS = 10  # profile_step.py's group of epochs
OUT = REPO / "exp" / "torch_profile_step"
HOST_CATEGORIES = ("cpu_op",)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def analyze(events: list[dict], steps: int = 0, batch: int = BATCH,
            flops_per_graph: float | None = None) -> dict:
    """The self-time table of a trace's device ops (its host ops where it
    holds none: a trace taken on the CPU), the card's busy time, and,
    given the traced steps, the table's ms a step and graphs/s."""
    timeline, self_times = "device", op_self_times(events)
    if not self_times:
        timeline, self_times = "host", op_self_times(events, HOST_CATEGORIES)
    rows = self_time_table(self_times)
    total_ms = sum(r["self_ms"] for r in rows)
    top = sorted(self_times.items(), key=lambda kv: -kv[1]["self_us"])
    out = {"timeline": timeline, "table": rows, "self_ms_total": total_ms,
           "device_busy_s": busy_seconds(events),
           "top_ops": [{"name": name[:100], "self_ms": rec["self_us"] / 1e3,
                        "count": rec["count"]} for (name, _), rec in top[:12]]}
    if steps and total_ms:
        per_step = total_ms / steps
        out["device_ms_per_step"] = per_step
        out["device_only_graphs_per_s"] = batch / (per_step / 1e3)
        if flops_per_graph:
            out["device_only_mfu"] = out["device_only_graphs_per_s"] * flops_per_graph \
                / FP32_FLOPS_PER_S
    return out


def markdown_table(rows: list[dict]) -> str:
    """``self_time_table``'s rows as ``profile_step.py`` prints its table."""
    lines = ["| op category | self ms | % time | n ops | kinds |", "|---|---|---|---|---|"]
    lines += [f"| {r['category']} | {r['self_ms']:.3f} | {100 * r['share']:.1f}% | "
              f"{r['ops']} | {r['kinds']} |" for r in rows]
    return "\n".join(lines)


def print_report(report: dict) -> None:
    print(f"\n{report['timeline']} self time, sum of the table: "
          f"{report['self_ms_total']:.3f} ms")
    if "device_ms_per_step" in report:
        print(f"{report['device_ms_per_step']:.4f} ms a step on the {report['timeline']} "
              f"(pack included) = {report['device_only_graphs_per_s']:,.0f} graphs/s")
    for key in ("graphs_per_s_traced", "graphs_per_s"):
        if report.get(key) is not None:
            print(f"{key}: {report[key]:,.1f}, MFU {100 * report[key.replace('graphs_per_s', 'mfu')]:.3f}%"
                  f" (67 TFLOP/s, {report['flops_per_graph'] / 1e6:.2f} MFLOP a graph)")
    print()
    print(markdown_table(report["table"]))
    print()


def profile(device=None, out: Path = OUT, epochs: int = EPOCHS, batch: int = BATCH,
            num_graphs: int = NUM_GRAPHS, hidden=HID, seed: int = 0) -> dict:
    """Pack the graphs and train ``epochs`` resident epochs under the
    profiler, then one epoch without it; → the report ``main`` prints."""
    dev = resolve_device(device)
    graphs = synthetic_qm8_graphs(num_graphs, seed=0, n_lo=8, n_hi=28)
    model = build_model(model_config(hidden))
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(dev)
    optimizer, scheduler, clip = build_optimizer(
        model.parameters(), {"optimizer": "Adam", "lr": 1e-3}, num_graphs // batch)
    step = make_train_step(model, optimizer, scheduler, clip)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    steps = num_graphs // batch
    _sync(dev)
    t_start = time.perf_counter()
    with trace(out, host=False):
        with torch.profiler.record_function("profile_step:pack"):
            ds = pack_dataset(graphs, n_max=N, num_eig_vec=K, standardize=True, device=dev)
            data = device_dataset(ds, dev)
            _sync(dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function("profile_step:epochs"):
            for _ in range(epochs):
                losses = train_epoch(step, data, device_permutation(gen, num_graphs, batch, dev))
            traced_loss = float(losses[-1])  # waits for the device
        traced_s = time.perf_counter() - t0
    trace_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    losses = train_epoch(step, data, device_permutation(gen, num_graphs, batch, dev))
    loss = float(losses[-1])
    untraced_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    events = load_trace(out)
    flops = qm8_train_flops_per_graph(hidden, N, K, SHORT, LONG, EDGE_TYPES, TASKS,
                                      FILTER_HIDDEN)
    report = analyze(events, steps * epochs, batch, flops)
    gps_traced = steps * epochs * batch / traced_s
    gps = steps * batch / untraced_s
    report.update(
        device=str(dev), kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        graphs=num_graphs, batch=batch, hidden=list(hidden), epochs=epochs,
        steps_per_epoch=steps, loss_traced=traced_loss, loss=loss,
        trace_wall_s=trace_s, traced_epochs_s=traced_s, untraced_epoch_s=untraced_s,
        graphs_per_s_traced=gps_traced, mfu_traced=gps_traced * flops / FP32_FLOPS_PER_S,
        graphs_per_s=gps, mfu=gps * flops / FP32_FLOPS_PER_S, flops_per_graph=flops,
        trace_file=str(Path(out) / "trace.json"), parse_s=time.perf_counter() - t0)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parse-only", metavar="TRACE.json",
                    help="analyse a saved Chrome trace; needs no card")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    if args.parse_only:
        report = analyze(load_trace(args.parse_only))
    else:
        report = profile(args.device, batch=args.batch)
    print_report(report)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
