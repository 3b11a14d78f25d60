"""The readings that the limits of ``limits/<workload>.json`` are set from,
for every cell of one configuration, in one process:

- ``program``: the check's numbers of sound runs of the program, one a
  seed (the lower readings): the graph drawn, the runner built, the
  first units driven as a run drives them in set-up (an infer cell's
  passes, then a train cell's first epochs on the same runner), and
  compared with the reference as a run compares them;
- ``control``: the reference put in the program's place one precision
  lower (fp8 for the bfloat16 activations, TF32 for the float32
  products, bfloat16 for stored float32), judged the same way;
- ``half_batch``: the reference with the training loss over half of the
  training nodes, the mean taken over those (train cells).

Each reading is one JSON line on standard output and in ``--out``:

    python3 portbench/readings.py --config ten_million_sparse_lanczos_net \\
        --seeds 11,12,13 --control-seeds 11,12,13 --out chiprun_out/readings.jsonl
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=0,
                    help="a smaller graph (a rehearsal on the CPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)

    import torch

    from portbench import bench
    from portbench.reference.common import CONTROL

    device = torch.device(args.device)
    names = [w["name"] for w in bench.load_json(ROOT / "BENCHMARK.json")["workloads"]
             if w["config"] == args.config]
    cells = sorted((bench.Cell(w) for w in names), key=lambda c: c.kind != "infer")
    hook = None
    if args.nodes:
        def hook(cfg):
            cfg = json.loads(json.dumps(cfg))
            cfg["dataset"]["num_nodes"] = args.nodes
            return cfg
    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    def readings(seed, sides):
        graph = bench.draw(cells[0], seed, device, hook)
        for c in cells[1:]:
            c.config = cells[0].config
        if "program" in sides:
            run_dir = Path(tempfile.mkdtemp(prefix="portbench-readings-"))
            try:
                t0 = time.perf_counter()
                prog, weights, base = bench.build_program(cells[0], graph, seed, device, run_dir)
                outs = {}
                for c in cells:
                    outs[c.name] = dict(base)
                    bench.drive_first(c, prog, weights, outs[c.name])
                setup = time.perf_counter() - t0
                del prog
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                for c in cells:
                    t0 = time.perf_counter()
                    nums = bench.compare(c, graph, weights, outs[c.name], seed, device)
                    emit({"cell": c.name, "side": "program", "seed": seed, **nums,
                          "setup_s": setup, "compare_s": time.perf_counter() - t0})
                del outs, base
            finally:
                shutil.rmtree(run_dir, ignore_errors=True)
        else:
            weights = bench.cell_weights(cells[0], graph, seed, device)
        for c in cells:
            for side in sides:
                if side == "program" or (side == "half_batch" and c.kind != "train"):
                    continue
                t0 = time.perf_counter()
                out = bench.reference_side(c, graph, weights, seed, device,
                                           CONTROL if side == "control" else bench.EXACT,
                                           half_batch=side == "half_batch")
                nums = bench.compare(c, graph, weights, out, seed, device)
                del out
                emit({"cell": c.name, "side": side, "seed": seed, **nums,
                      "seconds": time.perf_counter() - t0})
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in dict.fromkeys(seeds + control):
        sides = (["program"] if seed in seeds else []) + (
            ["control", "half_batch"] if seed in control else [])
        readings(seed, sides)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
