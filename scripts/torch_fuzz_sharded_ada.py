#!/usr/bin/env python3
"""Non-finite hunt in the node-sharded sparse AdaLanczosNet's loss and gradients.

Counterpart of ``scripts/fuzz_sharded_ada.py``: the same 60-node
synthetic graph (3 classes, 8 features, degree 4, seed 0) and the same
``SparseAdaLanczosNet`` (hidden (16,), 8 eigenvectors, short (1, 2),
long (3,), dropout 0), node-sharded over D ranks
(``SparseCitationRunner`` with ``train.shard: nodes``, the ranks started
by ``lanczosnet_torch/parallel/multihost.py:launch``; gloo on the CPU or
on a card the ranks share, NCCL where each rank has a card). The loss is
the mean cross-entropy over every real node. For each of ``2 × n_seeds``
weight seeds it draws the loss and the summed gradients and counts the
non-finite ones (the JAX script swept two PRNG implementations over
``n_seeds`` seeds each; the port has one generator, so the draws number
the same). Exits 1 if any draw is non-finite.

Run from the repository's root:

    python3 scripts/torch_fuzz_sharded_ada.py [n_seeds]            # 8 ranks on the card
    python3 scripts/torch_fuzz_sharded_ada.py 2 --ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from lanczosnet_torch.data.citation import synthetic_citation_edges  # noqa: E402
from lanczosnet_torch.models.sparse_nodes import build_sparse_model  # noqa: E402
from lanczosnet_torch.parallel import multihost  # noqa: E402
from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner  # noqa: E402
from lanczosnet_torch.utils.logger import setup_logging  # noqa: E402

MODEL = {"name": "AdaLanczosNet", "hidden_dim": [16], "num_eig_vec": 8,
         "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3], "dropout": 0.0}


def fuzz_graph() -> dict:
    """The 60-node graph, every node in the loss (``train_mask`` all set)."""
    g = synthetic_citation_edges(60, num_class=3, feat_dim=8, avg_degree=4.0, seed=0)
    g["train_mask"] = np.ones(len(g["labels"]), bool)
    return g


def fuzz_runner(ranks: int, device, save_dir: str, graph: dict | None = None):
    """The model on the graph: node-sharded over ``ranks`` (inside their
    group), or on one device for ``ranks`` 1."""
    cfg = {"seed": 0, "save_dir": save_dir, "dataset": {"name": "fuzz_ada"}, "model": MODEL,
           "train": {"optimizer": "SGD", "lr": 0.0, "num_devices": ranks,
                     **({"shard": "nodes"} if ranks > 1 else {})}}
    return SparseCitationRunner(cfg, device, graph=fuzz_graph() if graph is None else graph)


def set_weights(runner, seed: int) -> None:
    """Weights drawn from ``seed`` on the host, the same on every rank."""
    twin = build_sparse_model(MODEL, runner.x.shape[1], 3)
    twin.init_weights(torch.Generator().manual_seed(seed))
    runner.model.load_state_dict(twin.state_dict())


def loss_and_grads(runner) -> tuple[float, list[torch.Tensor]]:
    """One step at learning rate 0: the whole loss and the gradients
    summed over the ranks."""
    params = [p for p in runner.model.parameters() if p.requires_grad]
    loss = float(runner.make_train_step(torch.optim.SGD(params, lr=0.0))())
    return loss, [p.grad for p in params]


def rank_fuzz(n_seeds: int, device, save_dir: str) -> int:
    """A rank's part: every draw, counted; rank 0 prints."""
    world = multihost.world()
    setup_logging(None, "WARNING")
    runner = fuzz_runner(world.size, device, save_dir)
    bad = 0
    for seed in range(2 * n_seeds):
        set_weights(runner, seed)
        loss, grads = loss_and_grads(runner)
        gfin = all(bool(torch.isfinite(g).all()) for g in grads)
        if not (math.isfinite(loss) and gfin):
            bad += 1
            if world.rank == 0:
                print(f"NON-FINITE seed={seed} loss={loss} grads_finite={gfin}", flush=True)
        if world.rank == 0 and (seed + 1) % n_seeds == 0:
            print(f"{seed + 1} seeds done, cumulative bad={bad}", flush=True)
    if world.rank == 0:
        print(f"RESULT: {2 * n_seeds} draws on {world.size} ranks ({world.backend}, "
              f"{runner.device}), {bad} non-finite", flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_seeds", nargs="?", type=int, default=40)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="fuzz_ada_") as tmp:
        return multihost.launch(args.ranks, "torch_fuzz_sharded_ada:rank_fuzz",
                                [args.n_seeds, args.device, tmp], device=args.device,
                                store_dir=tmp, pythonpath=[str(Path(__file__).parent)])


if __name__ == "__main__":
    raise SystemExit(main())
