#!/usr/bin/env python3
"""Stress test for reads of unwritten memory in the node-sharded sparse
AdaLanczosNet and in the two Lanczos kernels.

Counterpart of ``scripts/repro_ada_nan.py``. A read of memory that
nothing wrote gives whatever the allocator handed back, so it shows only
deep into a long process. Each rank dirties the host heap and the
device's allocator (on the card, PyTorch's caching allocator) with
NaN-filled blocks of many sizes and frees them, so that the next
``torch.empty`` reuses them (``lanczosnet_torch/utils/poison.py``), then
evaluates the sharded loss and gradients of
``torch_fuzz_sharded_ada.py``'s model and graph (weights from seed 0),
``iters`` times. The sharded loss is first held to one device's on the
same weights (2e-5 relative): a wrong finite loss is a hit as much as a
NaN. A hit is retried on the same inputs, and the retry tells a race
(it differs) from a poisoned read (it persists). On the card rank 0 then
runs the Lanczos dispatch on both kernels over poisoned memory, B1 (B=64,
N=32, K=20) and B2 (Cora, N=2708, K=20), and holds all six outputs bit
for bit to a clean call. Exits 1 on any hit.

Run from the repository's root:

    python3 scripts/torch_repro_ada_nan.py [iters]             # 8 ranks on the card
    python3 scripts/torch_repro_ada_nan.py 3 --ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from torch_fuzz_sharded_ada import fuzz_runner, loss_and_grads, set_weights  # noqa: E402

from lanczosnet_torch.parallel import multihost  # noqa: E402
from lanczosnet_torch.utils.logger import setup_logging  # noqa: E402
from lanczosnet_torch.utils.poison import (  # noqa: E402
    dirty_device,
    dirty_host_heap,
    poisoned_lanczos_check,
)

LOSS_RTOL = 2e-5  # the sharded loss against one device's


def rank_repro(iters: int, device, save_dir: str) -> int:
    world = multihost.world()
    setup_logging(None, "WARNING")
    primary = world.rank == 0
    runner = fuzz_runner(world.size, device, save_dir)
    set_weights(runner, 0)
    l0, _ = loss_and_grads(runner)
    one = fuzz_runner(1, runner.device, f"{save_dir}/one_device_rank{world.rank}")
    set_weights(one, 0)
    ref, _ = loss_and_grads(one)
    if primary:
        print(f"baseline sharded loss {l0:.6f}, one device {ref:.6f}", flush=True)
    if not (math.isfinite(ref) and abs(l0 - ref) <= LOSS_RTOL * abs(ref)):
        if primary:
            print(f"BASELINE MISMATCH: sharded={l0} one device={ref}", flush=True)
        return 1

    rng = np.random.default_rng(world.rank)
    hits = 0
    for it in range(iters):
        dirty_host_heap(rng)
        dirty_device(runner.device, rng)
        loss, grads = loss_and_grads(runner)
        gfin = all(bool(torch.isfinite(g).all()) for g in grads)
        wrong = not abs(loss - ref) <= LOSS_RTOL * abs(ref)
        if not (math.isfinite(loss) and gfin) or wrong:
            hits += 1
            retry, _ = loss_and_grads(runner)
            print(f"HIT rank={world.rank} iter={it}: loss={loss} (one device {ref}) "
                  f"grads_finite={gfin} retry={retry} "
                  f"({'persists' if retry == loss else 'differs'})", flush=True)
        if primary and (it + 1) % 50 == 0:
            print(f"{it + 1}/{iters} iterations, hits={hits}", flush=True)

    kernels_bad = 0
    if primary and runner.device.type == "cuda":
        check = poisoned_lanczos_check(runner.device, rng)
        print(json.dumps({"poisoned_lanczos": check}), flush=True)
        kernels_bad = sum(not c["bit_equal"] for c in check.values())
    if primary:
        print(f"RESULT: {iters} iterations on {world.size} ranks ({world.backend}, "
              f"{runner.device}), {hits} non-finite/wrong-loss hits, "
              f"{kernels_bad} kernels differing over poisoned memory", flush=True)
    return 1 if hits or kernels_bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=300)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_ada_") as tmp:
        return multihost.launch(args.ranks, "torch_repro_ada_nan:rank_repro",
                                [args.iters, args.device, tmp], device=args.device,
                                store_dir=tmp, pythonpath=[str(HERE)])


if __name__ == "__main__":
    raise SystemExit(main())
