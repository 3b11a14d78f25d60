"""Rank 0's card memory while it packs a node-sharded citation graph,
in two designs.

``host``: what ``CitationRunner`` does on rank 0 of a node-sharded run,
``pack_citation(pad_to=D, device="cpu", spectral_device=<card>)``: the
operator stack is built on the host and only channel 0 goes to the card,
for the Ritz pairs (LanczosNet) or the partition (GPNN).
``card``: the whole pack on the card (``device=<card>``), every array
then moved to the host for the cut, as a runner without
``spectral_device`` would do it.

For each design: the card's peak MB over the pack, what it still holds
after the arrays are on the host, and the seconds. The graph is the
config's, cut as ``chip_smoke.py`` cuts it, drawn once. One JSON line a
design, each with the card's name and power limit.

Run from the repository's root on a machine with a CUDA card:

    python3 scripts/torch_pack_peak.py
    python3 scripts/torch_pack_peak.py --config pubmed_gpnn --ranks 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from lanczosnet_torch.data.citation import pack_citation  # noqa: E402
from lanczosnet_torch.train.citation_runner import citation_graph  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="pubmed_lanczos_net")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    smi = smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    cfg = smoke.citation_config_cut(args.config, 1)[0]
    mcfg = cfg["model"]
    graph = citation_graph(cfg["dataset"])
    kw = {"pad_to": args.ranks,
          "operator_kind": cfg["dataset"].get("operator_kind", "sym"),
          "num_eig_vec": int(mcfg.get("num_eig_vec", 20)) if mcfg["name"] == "LanczosNet" else 0,
          "num_cluster": int(mcfg.get("num_partition", 0)) if mcfg["name"] == "GPNN" else 0}
    designs = {"host": {"device": "cpu", "spectral_device": dev}, "card": {"device": dev}}
    for design, where in designs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        batch, splits = pack_citation(graph, **kw, **where)
        arrays = {f: t.cpu().numpy() for f, t in vars(batch).items()
                  if isinstance(t, torch.Tensor)}
        arrays.update({s: m.cpu().numpy() for s, m in splits.items()})
        del batch, splits
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        print(json.dumps({
            "design": design, "config": args.config, "ranks": args.ranks,
            "nodes": int(arrays["mask"].shape[1]),
            "peak_mb": (torch.cuda.max_memory_allocated() - before) / 2**20,
            "held_after_mb": (torch.cuda.memory_allocated() - before) / 2**20,
            "seconds": seconds, "nvidia_smi": smi}), flush=True)
        del arrays
    return 0


if __name__ == "__main__":
    sys.exit(main())
