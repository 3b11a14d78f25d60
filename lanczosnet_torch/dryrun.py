"""Multi-rank dry run: one training step of every parallel axis the port
ships, each held to one device's step on the same weights.

Counterpart of ``__graft_entry__.py:dryrun_multichip``, at its tiny
shapes (LanczosNet of hidden [64, 64], K=8, graphs of at most 16 nodes,
batches of 2·D). One ``parallel/multihost.launch`` of D ranks runs:

1. batch data parallelism (``parallel/comm.py``);
1b. device-shuffled resident epochs, each rank its rows of every batch
   (``train/scan_epoch.py``);
2. the node-sharded full graph: GCN on a Cora-shaped graph at scale
   0.07 through ``CitationRunner`` (``parallel/mesh.py:shard_full_graph``);
3.–5. edge-, node- and ring-sharded sparse GCN (``SparseCitationRunner``);
6. ring GAT;
7. tensor parallelism, tp=4 where D divides by 4, else 2 or 1
   (``parallel/tensor.py``);
8. ring AdaLanczosNet (the sharded recursion ``lanczos_tridiag_matvec``);
9. ring GPNN with ``sparse_spectral_partition``;
10. the ``export.py`` artifact round trip against the live ``Predictor``
   (rank 0).

Where the JAX dry run asks only for a finite loss, each rank here also
runs the axis on one device and the sharded loss must lie within 1e-5
relative of it; the artifact must answer what the Predictor answers
(0.0). Rank 0 prints a JSON line (every loss pair, the ranks' devices,
the Lanczos kernel's launches summed over the ranks) and last the JAX
format's line, ``dryrun(D): ok, dp_loss=…``. A failed axis raises in its
rank, naming the axis, and the exit code is not 0.

    python -m lanczosnet_torch.dryrun --ranks 4 --device cpu
    python -m lanczosnet_torch.dryrun --ranks 8          # the ranks share the card
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from lanczosnet_torch.data.dataset import PackedDataset, pack_dataset
from lanczosnet_torch.data.loader import to_device
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.export import export_predictor, load_predictor
from lanczosnet_torch.models import build_model
from lanczosnet_torch.models.base import set_dropout_generator
from lanczosnet_torch.ops import lanczos_cuda
from lanczosnet_torch.parallel import mesh, multihost
from lanczosnet_torch.parallel.tensor import TensorParallel
from lanczosnet_torch.serve import Predictor
from lanczosnet_torch.train.citation_runner import CitationRunner
from lanczosnet_torch.train.node_step import make_node_train_step
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.scan_epoch import device_dataset, device_permutation, train_epoch
from lanczosnet_torch.train.sparse_citation_runner import SparseCitationRunner
from lanczosnet_torch.train.step import make_train_step

# __graft_entry__.py:_model, the flagship's layers at a tiny width
TINY_LANCZOS_NET = {
    "name": "LanczosNet", "num_atom": 8, "num_task": 16, "hidden_dim": [64, 64],
    "embed_dim": 64, "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3, 5, 7],
    "num_eig_vec": 8, "spectral_filter_kind": "MLP",
}
N_MAX = 16
ADAM = {"optimizer": "Adam", "lr": 1e-3}
SPARSE_SGD_LR = 1e-2
RTOL = 1e-5  # a sharded loss against one device's, as the sharded tests hold it
# __graft_entry__.py's node-classification and sparse axes
CORA_DATASET = {"source": "synthetic", "name": "cora", "seed": 0, "scale": 0.07}
NODE_GCN = {"name": "GCN", "num_atom": 2, "hidden_dim": [32], "embed_dim": 32, "dropout": 0.0}
SPARSE_MODELS = {
    "gcn": {"name": "GCN", "hidden_dim": [16], "dropout": 0.0},
    "gat": {"name": "GAT", "hidden_dim": [16], "num_head": 2, "dropout": 0.0},
    "ada": {"name": "AdaLanczosNet", "hidden_dim": [16], "num_eig_vec": 8, "kernel_dim": 8,
            "short_diffusion_dist": [1, 2], "long_diffusion_dist": [3], "dropout": 0.0},
    "gpnn": {"name": "GPNN", "hidden_dim": [16], "num_partition": 2, "dropout": 0.0},
}


def tiny_split(num_graphs: int, device) -> PackedDataset:
    """``__graft_entry__.py:_tiny_batch``'s graphs, packed by the port."""
    graphs = synthetic_qm8_graphs(num_graphs, seed=0, n_lo=4, n_hi=N_MAX - 2)
    return pack_dataset(graphs, n_max=N_MAX, num_eig_vec=TINY_LANCZOS_NET["num_eig_vec"],
                        standardize=True, device=device)


def tiny_model(state: Optional[dict], device) -> torch.nn.Module:
    """The tiny LanczosNet: ``state`` where given, else weights from seed 0."""
    model = build_model(dict(TINY_LANCZOS_NET))
    if state is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state, strict=True)
    return model.to(device)


def _qm8_step(model, layout, device):
    """(train step, this rank's rows of a batch) on ``layout`` (None: one device)."""
    d, dp = (0, 1) if layout is None else (layout.d, layout.dp)
    tp = 1 if layout is None else layout.tp
    parallel = TensorParallel(model, layout.tp_comm) if tp > 1 else None
    params = list(model.parameters()) if parallel is None else parallel.parameters()
    set_dropout_generator(model, torch.Generator(device).manual_seed(0), rows=(d, dp))
    optimizer, scheduler, clip = build_optimizer(params, ADAM, 1)
    step = make_train_step(model, optimizer, scheduler, clip,
                           None if layout is None else layout.dp_comm, parallel)
    return step, (lambda bs: mesh.batch_rows(bs, dp, d))


def first_step_loss(ds: PackedDataset, state: Optional[dict], layout, device) -> float:
    """One Adam step of the tiny LanczosNet on all of ``ds`` as one batch,
    this rank's block of it (``layout``, a ``Mesh2D``; None: one device)
    → the whole batch's loss (axes 1 and 7)."""
    model = tiny_model(state, device)
    step, rows_of = _qm8_step(model, layout, device)
    rows = rows_of(len(ds))
    batch = to_device(ds.slice_batch(rows), device)
    return float(step(batch, torch.ones(rows.stop - rows.start, device=device), len(ds)))


def resident_epochs_loss(ds: PackedDataset, layout, device, epochs: int = 2) -> float:
    """Resident epochs with the device shuffle, batches of half the split
    (axis 1b) → the last step's loss."""
    model = tiny_model(None, device)
    step, rows_of = _qm8_step(model, layout, device)
    data = device_dataset(ds, device)
    gen = torch.Generator(device).manual_seed(1)
    bs = len(ds) // 2
    losses = [train_epoch(step, data, device_permutation(gen, len(ds), bs, device), rows_of(bs))
              for _ in range(epochs)]
    return float(losses[-1][-1])


def node_sharded_loss(world: int, save_dir: Path, device) -> float:
    """One step of a GCN on a Cora-shaped graph, node rows over ``world``
    ranks (1: one device) through ``CitationRunner`` (axis 2)."""
    cfg = {"seed": 0, "save_dir": str(save_dir), "dataset": dict(CORA_DATASET),
           "model": dict(NODE_GCN), "train": {**ADAM, "num_devices": world}}
    runner = CitationRunner(cfg, device)
    optimizer, scheduler, clip = build_optimizer(runner.model.parameters(), cfg["train"], 1)
    step = make_node_train_step(runner.model, optimizer, scheduler, clip, runner.comm)
    return float(step(runner.batch, runner.splits["train"], runner._count("train")))


def sparse_loss(model: str, shard: Optional[str], world: int, save_dir: Path, device) -> float:
    """One SGD step of a sparse model on a graph of 64·D nodes, sharded
    ``shard`` over ``world`` ranks (None: one device), through
    ``SparseCitationRunner`` (axes 3–6, 8, 9)."""
    graph = {"source": "synthetic_edges", "num_nodes": 64 * world, "num_class": 4,
             "feat_dim": 8, "avg_degree": 3.0, "seed": 2}
    train = {} if shard is None else {"num_devices": world, "shard": shard}
    cfg = {"seed": 0, "save_dir": str(save_dir), "dataset": graph,
           "model": dict(SPARSE_MODELS[model]), "train": train}
    runner = SparseCitationRunner(cfg, device)
    sgd = torch.optim.SGD(runner.model.parameters(), lr=SPARSE_SGD_LR)
    return float(runner.make_train_step(sgd)())


def export_round_trip(ds: PackedDataset, device, out_dir: Path) -> float:
    """The tiny LanczosNet after its first step behind a ``Predictor``,
    exported, loaded back without its model and asked the same requests
    → the largest difference of the answers (axis 10)."""
    model = tiny_model(None, device)
    step, _ = _qm8_step(model, None, device)
    step(to_device(ds.slice_batch(slice(None)), device), torch.ones(len(ds), device=device))
    pred = Predictor(tiny_model(None, device), model.state_dict(), n_max=N_MAX, batch_size=4,
                     num_eig_vec=TINY_LANCZOS_NET["num_eig_vec"], stats=ds.stats, device=device)
    requests = synthetic_qm8_graphs(3, seed=7, n_lo=4, n_hi=12)
    live = pred.predict(requests)
    art = load_predictor(export_predictor(pred, out_dir / "artifact"), device=device)
    got = art.predict(requests)
    if not np.isfinite(got).all():
        raise RuntimeError("the artifact's answers are not finite")
    return float(np.abs(got - live).max())


def tp_degree(ranks: int) -> int:
    return 4 if ranks % 4 == 0 else 2 if ranks % 2 == 0 else 1


def _check(axis: str, sharded: float, one: float) -> None:
    if not (math.isfinite(sharded) and abs(sharded - one) <= RTOL * abs(one)):
        raise RuntimeError(f"dryrun axis {axis}: sharded loss {sharded!r} against one "
                           f"device's {one!r} (rtol {RTOL})")


def run_rank(base_dir: str, state_path: str = "") -> int:
    """What each rank of the launch runs; rank 0 prints the result.
    ``state_path``: a ``torch.save``d state dict of the tiny LanczosNet
    for axes 1 and 7 (weights from seed 0 where empty)."""
    world = multihost.world()
    d, dev, rank = world.size, world.device, world.rank
    base = Path(base_dir)
    t0 = time.perf_counter()
    launches0 = lanczos_cuda.launches.count
    losses: dict[str, tuple[float, float]] = {}

    def axis(name: str, sharded: Callable[[], float], one: Callable[[], float]) -> None:
        try:
            pair = (sharded(), one())
        except Exception as exc:
            raise RuntimeError(f"dryrun axis {name} failed on rank {rank}: {exc}") from exc
        _check(name, *pair)
        losses[name] = pair

    state = torch.load(state_path, weights_only=True) if state_path else None
    ds = tiny_split(2 * d, dev)
    dp_layout = multihost.mesh2d(d, 1)
    axis("dp", lambda: first_step_loss(ds, state, dp_layout, dev),
         lambda: first_step_loss(ds, state, None, dev))
    ds4 = tiny_split(4 * d, dev)
    axis("device_shuffle", lambda: resident_epochs_loss(ds4, dp_layout, dev),
         lambda: resident_epochs_loss(ds4, None, dev))
    axis("node_sharded", lambda: node_sharded_loss(d, base / "node" / "sharded", dev),
         lambda: node_sharded_loss(1, base / "node" / f"one{rank}", dev))
    for name, model, shard in (("edge_sharded_sparse", "gcn", "edges"),
                               ("node_sharded_sparse", "gcn", "nodes"),
                               ("ring_sharded_sparse", "gcn", "nodes_ring"),
                               ("ring_gat", "gat", "nodes_ring")):
        axis(name, lambda: sparse_loss(model, shard, d, base / name / "sharded", dev),
             lambda: sparse_loss(model, None, d, base / name / f"one{rank}", dev))
    tp = tp_degree(d)
    if tp > 1:
        axis(f"tp{tp}", lambda: first_step_loss(ds, state, multihost.mesh2d(d // tp, tp), dev),
             lambda: first_step_loss(ds, state, None, dev))
    else:
        losses["tp1"] = (math.nan, math.nan)  # no mesh to cut over, as in the JAX dry run
    for name, model in (("ring_ada", "ada"), ("ring_gpnn", "gpnn")):
        axis(name, lambda: sparse_loss(model, "nodes_ring", d, base / name / "sharded", dev),
             lambda: sparse_loss(model, None, d, base / name / f"one{rank}", dev))
    export_err = None
    if rank == 0:
        try:
            export_err = export_round_trip(ds, dev, base / "export")
        except Exception as exc:
            raise RuntimeError(f"dryrun axis export failed: {exc}") from exc
        if export_err != 0.0:
            raise RuntimeError(f"dryrun axis export: the artifact differs from the Predictor "
                               f"by {export_err}")
    # what every rank ran on, and the Lanczos kernel's launches over the ranks
    devices = world.comm.all_gather(torch.tensor(
        [[dev.type == "cuda", -1 if dev.index is None else dev.index]], device=dev))
    launched = world.comm.all_reduce(torch.tensor(
        [lanczos_cuda.launches.count - launches0], dtype=torch.float64, device=dev))
    if rank == 0:
        print(json.dumps({"dryrun": {
            "ranks": d, "backend": world.backend, "losses": losses, "rtol": RTOL,
            "export_roundtrip_max_err": export_err,
            "devices": [f"cuda:{int(i)}" if c else "cpu" for c, i in devices.tolist()],
            "lanczos_launches": int(launched.item()), "seconds": time.perf_counter() - t0,
        }}), flush=True)
        fields = ", ".join(f"{name}_loss={sharded:.4f}" for name, (sharded, _) in losses.items())
        print(f"dryrun({d}): ok, {fields}, export_roundtrip_max_err={export_err:.2e}",
              flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One training step of every parallel axis on D ranks, each held to one "
                    "device's loss, and an export round trip.")
    ap.add_argument("--ranks", type=int, default=8, help="ranks to start (default 8)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; by default rank r takes card r %% cards")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds before the ranks stop")
    args = ap.parse_args(argv)
    if args.ranks < 2:
        ap.error("--ranks must be at least 2")
    with tempfile.TemporaryDirectory(prefix="lanczosnet_dryrun_") as tmp:
        code = multihost.launch(args.ranks, "lanczosnet_torch.dryrun:run_rank", [tmp],
                                device=args.device, store_dir=tmp, timeout=args.timeout)
    if code != 0:
        print(f"dryrun({args.ranks}): failed (exit code {code}); the failing rank's traceback "
              f"names the axis", file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
