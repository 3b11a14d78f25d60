"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``: each number the check compared beside
its limit); the last lines of standard error give the same numbers. It
exits 2 without a result where the card is missing, and 3 where JAX,
flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's build and kernel caches: fixed directories in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    sys.path[0] = str(ROOT)  # the checkout, not portbench/, heads the import path

    import torch

    from portbench.bench import Cell, forbidden_modules, run_cell

    chips = int(Cell(args.workload).entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    line, table, stages = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded what the port must not: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("stages " + " ".join(f"{k} {v:.3f}" for k, v in stages.items()), file=sys.stderr)
    for name, rec in table.items():
        print(f"check {name} {rec['value']!r} limit {rec['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
