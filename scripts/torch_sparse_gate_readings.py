"""Readings of ``chip_smoke.py``'s card-against-CPU gate of the float32
Pubmed sparse models across seeds.

For each config and seed the config's ``seed`` (the weights' init and
the dropout stream) is set, and the model goes through
``chip_smoke.sparse_citation_run`` as ``phase_sparse_citation`` runs
it (3 epochs, ``-t``, then the timed and profiled steps, whose updates
the gate's weights include; the Pubmed graph drawn once).
``chip_smoke.sparse_card_vs_cpu`` then gives the card's distance from
the CPU's eval logits at those weights, the control (the CPU's own
distance with the edges summed in other orders) and the gate's limit.
One JSON line per reading, then a summary line.

Run from the repository's root on a machine with a CUDA card:

    python3 scripts/torch_sparse_gate_readings.py
    python3 scripts/torch_sparse_gate_readings.py --configs pubmed_sparse_ada_lanczos_net \\
        --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from lanczosnet_torch.train.sparse_citation_runner import sparse_citation_graph  # noqa: E402

DEFAULT_CONFIGS = ("pubmed_sparse_ada_lanczos_net", "pubmed_sparse_lanczos_net")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(DEFAULT_CONFIGS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[1234, 1, 2, 3, 4, 5])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    smi = smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    graph, graph_key = None, None
    rows = []
    with tempfile.TemporaryDirectory(prefix="gate_readings_") as tmp:
        for name in args.configs:
            dcfg = smoke.citation_config_cut(name, smoke.SPARSE_CITATION_EPOCHS)[0]["dataset"]
            key = json.dumps(dcfg, sort_keys=True)
            if key != graph_key:
                graph = None  # one graph on the host at a time
                graph, graph_key = sparse_citation_graph(dcfg), key
            for seed in args.seeds:
                runner, out = smoke.sparse_citation_run(name, Path(tmp) / str(seed), graph, 0.0,
                                                        dev, smi, seed=seed)
                got = smoke.sparse_card_vs_cpu(runner)
                row = {"config": name, "seed": seed, "cut": out["cut"], **got,
                       "ratio_to_control": got["logits_max_abs_err_card_vs_cpu"]
                       / max(got["logits_max_abs_err_cpu_reordered"], 1e-30),
                       "passes": got["logits_max_abs_err_card_vs_cpu"] <= got["card_vs_cpu_limit"],
                       "nvidia_smi": smi}
                rows.append(row)
                print(json.dumps(row), flush=True)
                del runner
                torch.cuda.empty_cache()
    print(json.dumps({"readings": len(rows), "passes": sum(r["passes"] for r in rows),
                      "max_ratio_to_control": max(r["ratio_to_control"] for r in rows),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
