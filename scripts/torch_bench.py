#!/usr/bin/env python3
"""Headline benchmark of the port: the flagship's QM8-shape training throughput.

Counterpart of ``bench.py``. It measures the steady-state graphs/s of the
whole training step (forward, backward and Adam) of the flagship
LanczosNet at the reference's working point, which is defined here once
for the port's tools (``scripts/torch_profile_step.py`` imports it):
batch 64, N_max 32, K=20 Ritz pairs, hidden 128×3, short scales
[1, 2, 3], long scales [5, 7, 10, 20, 30], 16 tasks, MLP filters,
dropout 0.1, Adam at lr 1e-3, on 21,760 graphs of
``synthetic_qm8_graphs(seed=0, n_lo=8, n_hi=28)`` packed with
``standardize=True``.

The measurement is ``bench.py:bench_jax`` in the port's terms. The graphs
are packed on the card (the Ritz pairs by the shared-memory Lanczos
kernel, 256 graphs a chunk) into one resident dataset
(``train/scan_epoch.py:device_dataset``); one warm group of ``group``
resident epochs (``train_epoch`` over a ``device_permutation``) runs
first; ``rounds`` groups are timed, synchronized by reading the last
loss, which gives ``graphs_per_sec``; one more group runs under
``utils/profiling.py:trace(host=False)``, and the graphs it trained over
the card's busy time in that trace give ``device_only_graphs_per_sec``
and ``device_time_frac``. A trace that fails fails the run.

MFU divides the analytic FLOPs a graph
(``utils/profiling.py:qm8_train_flops_per_graph``, 148,550,016 at the
working point) by the card's peak for the model's dtype, named in the
output as ``peak_tflops``: 67 TFLOP/s for float32 (the H100 SXM's
float32 rate outside the tensor cores; TF32 is off in training,
``ops/precision.py``) and 989.4 TFLOP/s for bfloat16 (its dense BF16
tensor-core rate). On the CPU there is no peak and the MFU fields are
null.

``vs_baseline`` divides by ``bench_torch_cpu``, the same-shape eager
PyTorch-CPU proxy copied from ``bench.py``. Prints one JSON line with
``bench.py``'s keys, plus ``peak_tflops`` and ``device`` (the card's
name). Run from the repository's root:

    python3 scripts/torch_bench.py                      # on the card
    python3 scripts/torch_bench.py --dtype bfloat16
    python3 scripts/torch_bench.py --batch 128 --sum-dense
    python3 scripts/torch_bench.py --device cpu         # the CPU, minutes
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

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
    device_busy_seconds,
    qm8_train_flops_per_graph,
    trace,
)

# bench.py's working point, kept here: the port imports nothing of bench.py
BATCH = 64
N = 32
K = 20
HID = [128, 128, 128]
TASKS = 16
SHORT = [1, 2, 3]
LONG = [5, 7, 10, 20, 30]
FILTER_HIDDEN = 16
NUM_ATOM = 8
EDGE_TYPES = 4
DROPOUT = 0.1
LR = 1e-3
NUM_GRAPHS = 21760  # the reference's QM8 train split, rounded to a batch multiple
GROUP = 10  # resident epochs a timed group
ROUNDS = 2  # timed groups
METRIC = "lanczosnet_qm8_train_graphs_per_sec"
BASELINE = "same-shape eager PyTorch-CPU proxy (NOT the reference)"
# H100 SXM dense peaks at the 700 W limit, TFLOP/s: float32 outside the
# tensor cores (TF32 off) and BF16 on them
PEAK_TFLOPS = {"float32": FP32_FLOPS_PER_S / 1e12, "bfloat16": 989.4}


def model_config(hidden=HID, dtype: str = "float32", sum_dense: bool = False) -> dict:
    """The flagship's ``model:`` section at the working point."""
    return {"name": "LanczosNet", "num_atom": NUM_ATOM, "num_task": TASKS,
            "hidden_dim": list(hidden), "embed_dim": hidden[0],
            "short_diffusion_dist": SHORT, "long_diffusion_dist": LONG, "num_eig_vec": K,
            "spectral_filter_kind": "MLP", "filter_hidden_dim": FILTER_HIDDEN,
            "dropout": DROPOUT, "dtype": dtype, "sum_dense": sum_dense}


def bench_graphs(num_graphs: int = NUM_GRAPHS) -> list[dict]:
    return synthetic_qm8_graphs(num_graphs, seed=0, n_lo=8, n_hi=28)


def pack(graphs, device):
    """The bench's pack: N_max 32, K=20, labels standardized."""
    return pack_dataset(graphs, n_max=N, num_eig_vec=K, standardize=True, device=device)


def flops_per_graph() -> float:
    return qm8_train_flops_per_graph(HID, N, K, SHORT, LONG, EDGE_TYPES, TASKS, FILTER_HIDDEN)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_torch(dtype: str = "float32", batch: int = BATCH, sum_dense: bool = False,
                device=None, num_graphs: int = NUM_GRAPHS, group: int = GROUP,
                rounds: int = ROUNDS, seed: int = 0) -> dict:
    """Resident-epoch training throughput on ``device`` (the card unless
    named) → ``bench.py:bench_jax``'s fields, with the last loss, the
    pack's seconds, the peak and the device's name."""
    dev = resolve_device(device)
    steps = num_graphs // batch
    graphs = bench_graphs(num_graphs)
    model = build_model(model_config(HID, dtype, sum_dense))
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(dev)
    optimizer, scheduler, clip = build_optimizer(
        model.parameters(), {"optimizer": "Adam", "lr": LR}, steps)
    step = make_train_step(model, optimizer, scheduler, clip)
    gen = torch.Generator(dev).manual_seed(seed + 1)

    _sync(dev)
    t0 = time.perf_counter()
    data = device_dataset(pack(graphs, dev), dev)
    _sync(dev)
    pack_s = time.perf_counter() - t0

    def run_group() -> float:
        for _ in range(group):
            losses = train_epoch(step, data, device_permutation(gen, num_graphs, batch, dev))
        return float(losses[-1])  # waits for the device

    run_group()  # warm: first launches, the optimizer's first step
    t0 = time.perf_counter()
    for _ in range(rounds):
        loss = run_group()
    gps = rounds * group * steps * batch / (time.perf_counter() - t0)

    with tempfile.TemporaryDirectory(prefix="torch_bench_trace_") as trace_dir:
        with trace(trace_dir, host=False):
            run_group()
        busy = device_busy_seconds(trace_dir)
    device_gps = group * steps * batch / busy if busy else None

    fpg = flops_per_graph()
    tflops = gps * fpg / 1e12
    peak = PEAK_TFLOPS[dtype] if dev.type == "cuda" else None
    return {
        "graphs_per_sec": gps,
        "device_only_graphs_per_sec": device_gps,
        "device_time_frac": gps / device_gps if device_gps else None,
        "tflops_per_sec": tflops,
        "mfu_pct": 100.0 * tflops / peak if peak else None,
        "device_mfu_pct": (100.0 * device_gps * fpg / 1e12 / peak
                           if device_gps and peak else None),
        "flops_per_graph": fpg,
        "peak_tflops": peak,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "loss": loss,
        "pack_s": pack_s,
        "device_busy_s": busy,
    }


def bench_torch_cpu(batch: int = BATCH, steps: int = 6) -> float:
    """Same-shape eager PyTorch-CPU LanczosNet train step (baseline proxy)."""
    import torch.nn as nn

    torch.manual_seed(0)
    g = torch.Generator().manual_seed(0)
    s_op = torch.randn(batch, N, N, generator=g) * 0.1
    s_op = 0.5 * (s_op + s_op.transpose(1, 2))
    x_idx = torch.randint(1, 8, (batch, N), generator=g)
    d = torch.rand(batch, K, generator=g) * 2 - 1
    v = torch.randn(batch, N, K, generator=g) / np.sqrt(N)
    label = torch.randn(batch, TASKS, generator=g)
    ops_e = torch.randn(batch, 4, N, N, generator=g) * 0.1

    class TorchLanczosNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(8, HID[0])
            dims = [HID[0]] + HID
            self.filters = nn.ModuleList()
            self.layers = nn.ModuleList()
            for li, h in enumerate(HID):
                in_dim = dims[li] * (1 + len(SHORT) + len(LONG) + 4)
                self.layers.append(nn.Linear(in_dim, h))
                self.filters.append(
                    nn.ModuleList(
                        [
                            nn.Sequential(nn.Linear(2, 16), nn.ReLU(), nn.Linear(16, 1))
                            for _ in LONG
                        ]
                    )
                )
            self.att = nn.Linear(HID[-1], 1)
            self.out = nn.Linear(HID[-1], TASKS)

        def forward(self, idx):
            h = self.embed(idx)
            for li, lin in enumerate(self.layers):
                parts = [h]
                cur = h
                for t in range(max(SHORT)):
                    cur = torch.bmm(s_op, cur)
                    if (t + 1) in SHORT:
                        parts.append(cur)
                vtx = torch.bmm(v.transpose(1, 2), h)
                for si, t in enumerate(LONG):
                    feat = torch.stack([d, d**t], -1)
                    f = self.filters[li][si](feat).squeeze(-1)
                    parts.append(torch.bmm(v, f.unsqueeze(-1) * vtx))
                for e in range(4):
                    parts.append(torch.bmm(ops_e[:, e], h))
                h = torch.relu(lin(torch.cat(parts, -1)))
            gate = torch.sigmoid(self.att(h))
            return (gate * self.out(h)).sum(1)

    model = TorchLanczosNet()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    lossf = nn.L1Loss()

    def one_step():
        opt.zero_grad()
        loss = lossf(model(x_idx), label)
        loss.backward()
        opt.step()

    one_step()  # warmup
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    dt = time.perf_counter() - t0
    return steps * batch / dt


def metric_name(dtype: str, batch: int, sum_dense: bool) -> str:
    """``bench.py``'s metric name: the dtype, batch and layout suffixes."""
    return (METRIC + ("_bf16" if dtype == "bfloat16" else "")
            + (f"_b{batch}" if batch != BATCH else "") + ("_sumdense" if sum_dense else ""))


def result_line(r: dict, base: float, dtype: str, batch: int, sum_dense: bool) -> dict:
    """``bench.py``'s JSON line from ``bench_torch``'s result and the
    baseline's graphs/s, with the peak and the device's name added."""
    gps = r["graphs_per_sec"]
    vs = gps / base if base > 0 else None
    return {
        "metric": metric_name(dtype, batch, sum_dense),
        "value": round(gps, 1),
        "unit": f"graphs/sec (batch {batch}, N=32, K=20, fwd+bwd+adam)",
        # NOT the reference: it publishes no numbers; this divides by the
        # same-shape eager PyTorch-CPU proxy of this file
        "vs_baseline": round(vs, 2) if vs else 0.0,
        "baseline": BASELINE,
        "baseline_graphs_per_sec": round(base, 1),
        "tflops_per_sec": round(r["tflops_per_sec"], 2),
        "mfu_pct": round(r["mfu_pct"], 2) if r["mfu_pct"] else None,
        "device_only_graphs_per_sec": (round(r["device_only_graphs_per_sec"], 1)
                                       if r["device_only_graphs_per_sec"] else None),
        "device_time_frac": (round(r["device_time_frac"], 3)
                             if r["device_time_frac"] else None),
        "device_mfu_pct": round(r["device_mfu_pct"], 2) if r["device_mfu_pct"] else None,
        "flops_per_graph": round(r["flops_per_graph"]),
        "peak_tflops": r["peak_tflops"],
        "device": r["device"],
    }


def run(dtype: str = "float32", batch: int = BATCH, sum_dense: bool = False, device=None,
        **kwargs) -> tuple[dict, dict]:
    """The bench and its baseline → (the JSON line, ``bench_torch``'s
    whole result)."""
    r = bench_torch(dtype, batch, sum_dense, device, **kwargs)
    return result_line(r, bench_torch_cpu(batch), dtype, batch, sum_dense), r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=BATCH)
    # the concat-free layer Dense (model.sum_dense)
    ap.add_argument("--sum-dense", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    line, _ = run(args.dtype, args.batch, args.sum_dense, args.device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
