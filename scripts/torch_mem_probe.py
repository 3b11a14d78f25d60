#!/usr/bin/env python3
"""Device-memory probe for ``SparseCitationRunner`` configs.

Counterpart of ``scripts/mem_probe.py``: fit or no fit for a config
without a whole run. Where the JAX script compiles the runner's train
and eval programs and reads the compiler's buffer plan, the port has no
ahead-of-time program, so this script builds the runner and runs **one**
train step and one eval forward, and prints one JSON row per program:
the peak allocated and reserved bytes over it
(``lanczosnet_torch/utils/memory.py:peak_memory``: the caching
allocator's peaks on the card, with what the runner holds included)
beside the card's capacity (``torch.cuda.mem_get_info``). On the CPU the
byte columns come from a tracker of live tensors and no capacity is
given.

``--stub-precompute`` replaces the runner's Ritz precompute with zeros of
the right shape, as the JAX flag does: the rows depend on shapes only,
and the 10M-node Lanczos recursion takes its own time. A config with
``train.num_devices`` above 1 is refused by name: its ranks are started
by the CLI (``python -m lanczosnet_torch.cli -c <config>``), and each
logs its peak in its ``metrics.rank<r>.jsonl``.

Run from the repository's root:

    python3 scripts/torch_mem_probe.py -c configs/ten_million_sparse_lanczos_net.yaml
    python3 scripts/torch_mem_probe.py -c configs/pubmed_sparse_gcn.yaml --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Iterator, Mapping

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import lanczosnet_torch.train.sparse_citation_runner as scr  # noqa: E402
from lanczosnet_torch.train.optim import build_optimizer  # noqa: E402
from lanczosnet_torch.utils.config import load_config  # noqa: E402
from lanczosnet_torch.utils.logger import setup_logging  # noqa: E402
from lanczosnet_torch.utils.memory import peak_memory  # noqa: E402


def stub_ritz(op, k: int, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeros of the shapes ``sparse_lanczos_ritz`` returns."""
    return (torch.zeros(k, device=op.val.device),
            torch.zeros(op.n, k, device=op.val.device))


@contextlib.contextmanager
def stubbed_precompute(enable: bool) -> Iterator[None]:
    saved = scr.sparse_lanczos_ritz
    if enable:
        scr.sparse_lanczos_ritz = stub_ritz
    try:
        yield
    finally:
        scr.sparse_lanczos_ritz = saved


def _tensors(runner) -> list[torch.Tensor]:
    """What the runner holds: features, labels, masks, the operator's
    arrays and the extras (the ``MemTracker`` must be told of them)."""
    op = runner.op
    held = [runner.x, runner.labels, *runner.splits.values(), *runner.extras]
    held += [t for t in (op.row, op.col, op.val, getattr(op, "col_perm", None))
             if isinstance(t, torch.Tensor)]
    return held


def probe(config: Mapping, device=None, stub_precompute: bool = False,
          graph: dict | None = None) -> list[dict]:
    """Build the runner (on ``graph`` where given) and run one train step
    and one eval forward; → one row per program."""
    name = config.get("exp_name", "config")
    runner_name = config.get("runner", "QM8Runner")
    if runner_name != "SparseCitationRunner":
        raise SystemExit(f"{name}: runner {runner_name} is not probed; the probe is for "
                         "SparseCitationRunner configs, as the JAX script's")
    ranks = int(config["train"].get("num_devices", 1) or 1)
    if ranks > 1:
        raise SystemExit(
            f"{name}: train.num_devices={ranks}; a sharded config is not probed here: "
            f"run it with `python -m lanczosnet_torch.cli -c <config>`, whose ranks log "
            "their peaks in metrics.rank<r>.jsonl")
    with stubbed_precompute(stub_precompute):
        runner = scr.SparseCitationRunner(config, device, graph=graph)
    dev = runner.device
    optimizer, scheduler, clip = build_optimizer(runner.model.parameters(), config["train"])
    step = runner.make_train_step(optimizer, scheduler, clip)
    params = runner.model.parameters()
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    capacity = torch.cuda.mem_get_info(dev) if dev.type == "cuda" else None
    rows = []
    for program, fn in (("train_step", step), ("eval", lambda: runner.accuracy("val"))):
        mem = peak_memory(fn, dev, (runner.model, optimizer, *_tensors(runner)))
        row = {"program": program, "config": name, "device": str(dev),
               "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "num_devices": 1, "nodes": runner.op.n, "edges": runner.op.num_edges,
               "dtype": str(runner.model.dtype), "remat": runner.remat,
               "stub_precompute": bool(stub_precompute), "param_bytes": param_bytes, **mem}
        if capacity is not None:
            free, total = capacity
            row.update(capacity_bytes=int(total), free_bytes_after=int(free),
                       fits=row["peak_reserved_bytes"] <= total,
                       margin_gb=round((total - row["peak_reserved_bytes"]) / 1024**3, 2))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--stub-precompute", action="store_true",
                    help="zeros of the right shape in place of the Ritz precompute")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    config = load_config(args.config, comment="mem_probe")
    setup_logging(Path(config.save_dir) / "run.log", "INFO")
    for row in probe(config, args.device, args.stub_precompute):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
