#!/usr/bin/env python3
"""Train every shipped config with the port and write RESULTS_TORCH.md.

Counterpart of ``scripts/run_all.py``, which writes ``RESULTS.md`` for
the JAX package; this file is the port's own. The same sections and
columns: the QM8-shaped regression configs (``--qm8-epochs``, 30 by
default), the dense citation configs and the sparse ones, with test
scores and wall seconds. A config that runs on more ranks than there
are cards (``lanczosnet_torch/cli.py:num_ranks`` against
``torch.cuda.device_count()``) is skipped, and the reason printed; one
that fits runs on its ranks through the CLI's launcher. The header
names the card and its power limit as ``nvidia-smi`` gives them.

Run from the repository's root (the runs land under ``exp/``):

    python3 scripts/torch_run_all.py
    python3 scripts/torch_run_all.py --only qm8_gcn --qm8-epochs 1 --out /tmp/r.md
    python3 scripts/torch_run_all.py --device cpu --only cora_gcn
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lanczosnet_torch.cli import num_ranks  # noqa: E402
from lanczosnet_torch.parallel import multihost  # noqa: E402
from lanczosnet_torch.train.runner import build_runner  # noqa: E402
from lanczosnet_torch.utils.device import resolve_device  # noqa: E402
from lanczosnet_torch.utils.config import load_config, loads, save_config  # noqa: E402
from lanczosnet_torch.utils.logger import setup_logging  # noqa: E402

# the manual sections of the file kept below the tables, as run_all.py keeps them
KEPT_SECTIONS = ("## Long-training flagships", "## Beyond-Pubmed")


def _override(cfg, overrides: dict) -> None:
    for dotted, v in overrides.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v


def _launched_result(cfg) -> dict:
    """A run on several ranks: rank 0's last ``test`` event."""
    recs = [json.loads(line) for line in
            (Path(cfg.save_dir) / "metrics.jsonl").read_text().splitlines() if line.strip()]
    test = [r for r in recs if r.get("event") == "test"][-1]
    if cfg.get("runner", "QM8Runner") == "QM8Runner":
        return {"best_val_mae": test["best_val"], "test_mae": test["mae"]}
    return {"best_val_acc": test["best_val"], "test_acc": test["acc"]}


def run_config(path: Path, overrides: dict, device=None) -> dict:
    """Train ``path`` with the dotted ``overrides`` → its result, with
    ``wall_s`` and ``exp`` (the config's name)."""
    cfg = load_config(path)
    _override(cfg, overrides)
    save_config(cfg, Path(cfg.save_dir) / "config.yaml")
    ranks = num_ranks(cfg)
    t0 = time.perf_counter()
    if ranks > 1:
        code = multihost.launch(ranks, "lanczosnet_torch.cli:run_rank",
                                [str(Path(cfg.save_dir) / "config.yaml"), False, "INFO", device],
                                device=device, store_dir=cfg.save_dir)
        if code != 0:
            raise RuntimeError(f"{path.stem}: {ranks} ranks exited {code}; see {cfg.save_dir}")
        result = _launched_result(cfg)
    else:
        result = build_runner(cfg, device).train()
    result["wall_s"] = round(time.perf_counter() - t0, 1)
    result["exp"] = path.stem
    return result


def card_line(device) -> str:
    """``name, power limit`` of the card as ``nvidia-smi`` gives them, or
    the CPU where the runs took it."""
    if device is not None and torch.device(device).type == "cpu":
        return "the CPU (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def results_markdown(qm8: list, citation: list, sparse: list, qm8_epochs: int,
                     produced_on: str, old: str | None = None) -> str:
    """The file: run_all.py's sections and columns, then the kept manual
    sections of ``old``."""
    lines = [
        "# RESULTS (PyTorch port)",
        "",
        f"Produced by `scripts/torch_run_all.py` on {produced_on}. Datasets are",
        "the deterministic synthetic stand-ins (`data/qm8.py`,",
        "`data/citation.py`) — the real QM8/Planetoid files are not",
        "available offline; swap `dataset.source` to use",
        "them when present. Label MAE is in original (unstandardized)",
        "units of the synthetic targets.",
        "",
    ]
    if qm8:
        lines += [
            f"## QM8-shaped regression ({qm8_epochs} epochs, batch 64, 2048/256/256 graphs)",
            "",
            "| config | val MAE | test MAE | wall s |",
            "|---|---|---|---|",
        ]
        for r in qm8:
            test = r["test_mae"] if r["test_mae"] is not None else float("nan")
            lines.append(f"| {r['exp']} | {r['best_val_mae']:.5f} | {test:.5f} | {r['wall_s']} |")
        lines.append("")
    if citation:
        lines += [
            "## Citation node classification (Planetoid protocol, synthetic "
            "SBM at dataset scale)",
            "",
            "| config | val acc | test acc | wall s |",
            "|---|---|---|---|",
        ]
        for r in citation:
            lines.append(f"| {r['exp']} | {r['best_val_acc']:.4f} | "
                         f"{r['test_acc']:.4f} | {r['wall_s']} |")
        lines.append("")
    if sparse:
        lines += [
            "## Sparse full-graph path (COO segment-sum, SparseCitationRunner)",
            "",
            "Memory scales with edges instead of N² — the path for graphs",
            "beyond Pubmed. All nine model families have sparse members;",
            "edge- and node-sharded modes in `tests/test_torch_sharded_sparse.py`.",
            "",
            "| config | val acc | test acc | wall s |",
            "|---|---|---|---|",
        ]
        for r in sparse:
            lines.append(f"| {r['exp']} | {r['best_val_acc']:.4f} | "
                         f"{r['test_acc']:.4f} | {r['wall_s']} |")
        lines.append("")
    if old is not None:
        kept = old.splitlines()
        for marker in KEPT_SECTIONS:
            idx = [i for i, line in enumerate(kept) if line.startswith(marker)]
            if idx:
                lines += kept[idx[0]:]
                break
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qm8-epochs", type=int, default=30)
    ap.add_argument("--only", default="", help="substring filter on config name")
    ap.add_argument("--out", default=str(REPO / "RESULTS_TORCH.md"))
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    setup_logging(None, "INFO")
    on_cpu = resolve_device(args.device).type == "cpu"  # raises without a card
    devices = (os.cpu_count() or 1) if on_cpu else torch.cuda.device_count()
    produced_on = card_line(args.device)

    qm8, citation, sparse = [], [], []
    for path in sorted((REPO / "configs").glob("*.yaml")):
        if args.only and args.only not in path.stem:
            continue
        probe = loads(path.read_text())
        ranks = num_ranks(probe)
        if ranks > devices:
            print(f"skip {path.stem}: needs {ranks} {'cores' if on_cpu else 'cards'} "
                  f"(have {devices})", flush=True)
            continue
        if path.stem.startswith("qm8"):
            qm8.append(run_config(path, {"train.max_epoch": args.qm8_epochs}, args.device))
            res = qm8[-1]
        elif probe.get("runner") == "SparseCitationRunner":
            sparse.append(run_config(path, {}, args.device))
            res = sparse[-1]
        else:
            citation.append(run_config(path, {}, args.device))
            res = citation[-1]
        print(json.dumps(res), flush=True)

    out = Path(args.out)
    old = out.read_text() if out.exists() else None
    out.write_text(results_markdown(qm8, citation, sparse, args.qm8_epochs, produced_on, old))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
