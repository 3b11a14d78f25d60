"""Full-graph citation experiment runner (Cora/Citeseer/Pubmed family).

Counterpart of ``lanczosnet_tpu/train/citation_runner.py``:
semi-supervised node classification on one large graph in the Planetoid
protocol. Full-batch gradient steps on the training-node mask,
validation every epoch, a snapshot of the best validation accuracy,
early stopping, resume, and test on the best snapshot. The graph stays
on the device for the whole run.

    runner = CitationRunner(config)            # on the card
    runner = CitationRunner(config, "cpu")     # where the caller asks
    runner.train(); runner.test()

``config`` is a plain mapping with the keys of ``configs/cora_*.yaml``:
``dataset``, ``model``, ``train``, ``test``, ``seed``, ``save_dir``.
Options the port does not run yet (``train.tensorboard``,
``train.profile``, …) raise, naming their ROADMAP item, and options the
JAX runner does not read (``train.tp``, ``train.shard``) raise
``ValueError`` (``train/unported.py``, the tables ``QM8Runner`` checks
too); ``train.prng_impl``, JAX's choice of random bit generator, is
accepted and has no effect.

``train.num_devices: D > 1`` splits the graph's node axis over the D
ranks of a process group (``parallel/multihost.py``; the CLI starts
them), as the JAX runner's ``shard_full_graph`` splits it over a mesh.
Rank 0 packs the graph padded to a multiple of D (on the host; the Ritz
pairs and GPNN's partition on its card) and sends each rank only its
piece (``parallel/mesh.py:shard_full_graph``): the operator rows
``[1, E+1, N/D, N]``, its rows of every node array, the Ritz values
and the column vectors whole; then it drops the whole graph. Every
model runs its one-device code on the piece (``core/graph_batch.py``:
the gathers, sums and diagonals of a row block). A rank's loss is its
share and the gradients get one all-reduce a step
(``train/node_step.py``); dropout draws one device's masks on every
rank (``models/base.py:Dropout`` on the node axis). Only rank 0 writes
checkpoints, in the one-device format, and ``run.log`` and
``metrics.jsonl``; rank r writes ``metrics.rank<r>.jsonl``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from lanczosnet_torch.core.graph_batch import GraphBatch, NodeShard
from lanczosnet_torch.data.citation import (
    import_planetoid,
    pack_citation,
    synthetic_citation_graph,
)
from lanczosnet_torch.models import build_model
from lanczosnet_torch.models.base import set_dropout_generator
from lanczosnet_torch.ops import lanczos_cuda
from lanczosnet_torch.parallel import mesh, multihost
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.train.node_step import make_node_eval_step, make_node_train_step
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.unported import refuse_unported
from lanczosnet_torch.utils.device import resolve_device
from lanczosnet_torch.utils.logger import MetricsLogger, get_logger
from lanczosnet_torch.utils.memory import host_peak_rss_mb

BATCH_FIELDS = ("atom_type", "node_feat", "ops", "mask", "label", "ritz_val", "ritz_vec",
                "cluster", "node_label")
SPLITS = ("train", "val", "test")


def citation_graph(dcfg: Mapping) -> dict:
    """The graph of a ``dataset:`` section: ``source: planetoid`` reads
    the files in ``data_dir``; ``synthetic`` (the default) draws the
    stand-in of ``name`` at ``scale`` from ``seed`` (7)."""
    source = dcfg.get("source", "synthetic")
    if source == "planetoid":
        return import_planetoid(dcfg["data_dir"], dcfg["name"])
    if source != "synthetic":
        raise ValueError(f"dataset.source={source!r}: expected synthetic or planetoid")
    return synthetic_citation_graph(
        dcfg.get("name", "cora"),
        seed=int(dcfg.get("seed", 7)),
        scale=float(dcfg.get("scale", 1.0)),
    )


class CitationRunner:
    def __init__(self, config: Mapping, device: str | torch.device | None = None):
        refuse_unported(config, "CitationRunner")
        self.config = config
        ndev = int(config["train"].get("num_devices") or 1)
        self.world = multihost.initialize(ndev, device) if ndev > 1 else None
        self.device = resolve_device(device) if self.world is None else self.world.device
        self.comm = None if self.world is None else self.world.comm
        self.rank = 0 if self.world is None else self.world.rank
        self.log = get_logger()
        self.run_dir = Path(config["save_dir"])
        self.metrics = MetricsLogger(
            self.run_dir / ("metrics.jsonl" if self.rank == 0
                            else f"metrics.rank{self.rank}.jsonl"),
            # the TensorBoard mirror is rank 0's
            tensorboard_dir=(self.run_dir / "tb"
                             if config["train"].get("tensorboard") and self.rank == 0 else None))
        self.ckpt = Checkpointer(self.run_dir, writer=self.rank == 0)
        self._launches0 = (lanczos_cuda.stream_launches.count, lanczos_cuda.plain_routes.count)

        dcfg = config["dataset"]
        mcfg = dict(config["model"])
        mcfg["task"] = "node"
        t0 = time.perf_counter()
        if self.world is None:
            graph = citation_graph(dcfg)
            self.batch, self.splits = self._pack(graph, mcfg, 1, self.device)
            meta = {"num_class": int(graph["num_class"]), "n_true": graph["features"].shape[0]}
            del graph
        else:
            self.batch, self.splits, meta = self._build_sharded(dcfg, mcfg)
        setup_s = time.perf_counter() - t0
        self.n_true = meta["n_true"]
        self.n_pad = self.batch.n_nodes
        # the whole graph's nodes of each split: a sharded loss's denominator
        self.split_count = meta.get("split_count")

        mcfg.setdefault("num_atom", 2)
        mcfg["num_task"] = meta["num_class"]
        # widths that flax infers from the first batch
        mcfg["num_edge_type"] = self.batch.num_ops - 1
        mcfg["node_feat_dim"] = self.batch.node_feat.shape[-1]
        self.model = build_model(mcfg)
        self.model.init_weights(torch.Generator().manual_seed(int(config["seed"])))
        self.model.to(self.device)
        self.dropout_generator = torch.Generator(self.device).manual_seed(int(config["seed"]))
        set_dropout_generator(self.model, self.dropout_generator, rows=(self.rank, ndev), axis=1)
        setup = {"setup_s": setup_s, "rows": self.batch.n_max, "n_pad": self.n_pad,
                 **meta.get("seconds", {}), "host_peak_rss_mb": host_peak_rss_mb(),
                 **self._peak_memory(), **self._launches()}
        if self.world is not None:
            setup.update(self.world.describe(), comm=self.comm.stats.as_dict())
        else:
            setup.update(device=str(self.device))
        self.metrics.log("setup", **setup)
        self.log.info(
            "citation runner: model=%s dataset=%s nodes=%d (pad %d) classes=%d devices=%d "
            "device=%s", mcfg["name"], dcfg.get("name", "cora"), self.n_true, self.n_pad,
            meta["num_class"], ndev, self.device,
        )

    # ------------------------------------------------------------------ set-up
    def _pack(self, graph: dict, mcfg: dict, pad_to: int, device, spectral_device=None):
        # only LanczosNet reads Ritz pairs from the batch; AdaLanczosNet
        # computes its own inside the forward
        name = mcfg["name"]
        return pack_citation(
            graph,
            pad_to=pad_to,
            operator_kind=self.config["dataset"].get("operator_kind", "sym"),
            num_eig_vec=int(mcfg.get("num_eig_vec", 20)) if name == "LanczosNet" else 0,
            num_cluster=int(mcfg.get("num_partition", 0)) if name == "GPNN" else 0,
            device=device,
            spectral_device=spectral_device,
        )

    def _cut(self, dcfg: Mapping, mcfg: dict) -> tuple[dict, list]:
        """Rank 0: draw and pack the whole graph (on the host, the Ritz
        pairs and the partition on this rank's card), cut every rank's
        piece → (meta, the pieces)."""
        d = self.world.size
        t0 = time.perf_counter()
        graph = citation_graph(dcfg)
        graph_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch, splits = self._pack(graph, mcfg, d, "cpu", self.device)
        pack_s = time.perf_counter() - t0
        arrays = {f: getattr(batch, f).numpy() for f in BATCH_FIELDS
                  if getattr(batch, f) is not None}
        arrays.update({f"split.{s}": splits[s].numpy() for s in SPLITS})
        cut = {k for k, axis in mesh.node_axes(arrays).items() if axis is not None}
        pieces = [mesh.shard_full_graph(arrays, d, r) for r in range(d)]
        meta = {"num_class": int(graph["num_class"]), "n_true": graph["features"].shape[0],
                "n_pad": batch.n_max,
                "split_count": {s: float(graph[f"{s}_mask"].sum()) for s in SPLITS},
                "arrays": {k: (v.shape, v.dtype.str, k in cut) for k, v in pieces[0].items()},
                "seconds": {"graph_s": graph_s, "pack_s": pack_s}}
        return meta, pieces

    def _build_sharded(self, dcfg: Mapping, mcfg: dict):
        """Every rank: receive this rank's piece from rank 0 → (its batch,
        its rows of the split masks, the meta)."""
        comm, d = self.comm, self.world.size
        meta, pieces = self._cut(dcfg, mcfg) if self.rank == 0 else (None, None)
        t0 = time.perf_counter()
        meta = comm.broadcast_object(meta)
        mine = {}
        for key, (shape, dtype, cut) in meta["arrays"].items():
            if cut:
                mine[key] = comm.scatter_arrays(
                    None if pieces is None else [p[key] for p in pieces], shape, np.dtype(dtype))
            else:
                mine[key] = comm.broadcast_array(
                    None if pieces is None else pieces[0][key], shape, np.dtype(dtype))
        del pieces  # rank 0 keeps no more of the whole graph than its piece
        meta["seconds"]["scatter_s"] = time.perf_counter() - t0

        def put(key):
            return None if key not in mine else torch.from_numpy(mine[key]).to(self.device)

        shard = NodeShard(comm, self.rank * meta["n_pad"] // d, put("col.mask"),
                          put("col.cluster"))
        batch = GraphBatch(**{f: put(f) for f in BATCH_FIELDS}, shard=shard)
        splits = {s: put(f"split.{s}") for s in SPLITS}
        return batch, splits, meta

    def _peak_memory(self) -> dict:
        """The card's peak MB since the process began, and what it holds
        now (at set-up: rank 0 after dropping the whole graph)."""
        if self.device.type != "cuda":
            return {}
        return {"peak_memory_mb": torch.cuda.max_memory_allocated(self.device) / 2**20,
                "memory_mb": torch.cuda.memory_allocated(self.device) / 2**20}

    def _launches(self) -> dict:
        """The streamed Lanczos kernel's launches in this process since
        the runner was built, and the calls its shape sent to the plain
        version (``ops/lanczos_cuda.py``)."""
        return {"stream_launches": lanczos_cuda.stream_launches.count - self._launches0[0],
                "plain_routes": lanczos_cuda.plain_routes.count - self._launches0[1]}

    # ------------------------------------------------------------------ steps
    def _count(self, split: str):
        """The whole graph's nodes of ``split`` where sharded, else None
        (the step counts its own mask)."""
        return None if self.split_count is None else self.split_count[split]

    def forward(self) -> torch.Tensor:
        """This rank's logits ``[1, rows, C]`` in the model's mode."""
        return self.model(self.batch)

    @torch.no_grad()
    def gathered_logits(self) -> torch.Tensor:
        """The eval-mode logits of the real nodes ``[N, C]`` on every rank
        (sharded: the row blocks all-gathered)."""
        self.model.eval()
        logits = self.forward()[0]
        if self.comm is not None:
            logits = self.comm.all_gather(logits)
        return logits[: self.n_true]

    def _state(self, optimizer, scheduler) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
        }

    def _load_state(self, state: dict, optimizer=None, scheduler=None) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
            scheduler.load_state_dict(state["scheduler"])

    def _accuracy(self, eval_step, split: str) -> float:
        correct, count, _ = eval_step(self.batch, self.splits[split])
        return float(correct) / max(float(count), 1.0)

    def train(self) -> dict:
        tcfg = self.config["train"]
        optimizer, scheduler, grad_clip = build_optimizer(
            self.model.parameters(), tcfg, steps_per_epoch=1
        )
        train_step = make_node_train_step(self.model, optimizer, scheduler, grad_clip, self.comm)
        eval_step = make_node_eval_step(self.model, self.comm)

        max_epoch = int(tcfg.get("max_epoch", 200))
        patience = int(tcfg.get("patience", 50))
        display = int(tcfg.get("display_iter", 20))
        snapshot_every = max(1, int(tcfg.get("snapshot_epoch", 50)))
        start_epoch = 0
        best_val, best_epoch = -1.0, -1
        if tcfg.get("is_resume") and self.ckpt.exists("latest"):
            self._load_state(self.ckpt.restore("latest", self.device), optimizer, scheduler)
            start_epoch = int((self.ckpt.meta("latest") or {}).get("epoch", -1)) + 1
            best_meta = self.ckpt.meta("best") or {}
            best_val = float(best_meta.get("val_acc", -1.0))
            best_epoch = int(best_meta.get("epoch", -1))
            self.log.info("resumed from epoch %d (best val so far %.4f)", start_epoch, best_val)
        elif tcfg.get("resume_model"):
            self._load_state(Checkpointer.restore_file(tcfg["resume_model"], self.device,
                                                      self.config["model"]["name"]))
            self.log.info("warm-started from %s", tcfg["resume_model"])

        t0 = time.perf_counter()
        for epoch in range(start_epoch, max_epoch):
            lr = scheduler.get_last_lr()[0]
            t_step = time.perf_counter()
            comm0 = None if self.comm is None else self.comm.stats.copy()
            loss = float(train_step(self.batch, self.splits["train"], self._count("train")))
            step_s = time.perf_counter() - t_step
            comm = {} if comm0 is None else {"comm": self.comm.stats.minus(comm0)}
            val_acc = self._accuracy(eval_step, "val")
            self.metrics.log("epoch", epoch=epoch, loss=loss, step_seconds=step_s, **comm,
                             **self._launches())
            if epoch % display == 0:
                self.log.info(
                    "epoch %d | train CE %.4f | val acc %.4f | lr %.2e", epoch, loss, val_acc, lr
                )
                self.metrics.log("train", epoch=epoch, loss=loss, val_acc=val_acc)
            if val_acc > best_val:
                best_val, best_epoch = val_acc, epoch
                self.ckpt.save("best", self._state(optimizer, scheduler),
                               {"epoch": epoch, "val_acc": val_acc})
            if (epoch + 1) % snapshot_every == 0:
                self.ckpt.save("latest", self._state(optimizer, scheduler), {"epoch": epoch})
            if epoch - best_epoch > patience:
                self.log.info("early stop at epoch %d", epoch)
                break
        wall = time.perf_counter() - t0

        # sharded: rank 0 may still be writing "best" when the others get here
        multihost.barrier()
        self._load_state(self.ckpt.restore("best", self.device))
        test_acc = self._accuracy(eval_step, "test")
        self.log.info(
            "best val acc %.4f (epoch %d) | test acc %.4f | %.1fs total",
            best_val, best_epoch, test_acc, wall,
        )
        self.metrics.log("test", acc=test_acc, best_val=best_val, wall_s=wall,
                         host_peak_rss_mb=host_peak_rss_mb(), **self._peak_memory(),
                         **self._launches())
        return {"best_val_acc": best_val, "test_acc": test_acc}

    def test(self) -> dict:
        path = (self.config.get("test") or {}).get("test_model")
        if path:
            state = Checkpointer.restore_file(path, self.device, self.config["model"]["name"])
        elif self.ckpt.exists("best"):
            state = self.ckpt.restore("best", self.device)
        else:
            raise FileNotFoundError("no checkpoint: set test.test_model or train")
        self._load_state(state)
        acc = self._accuracy(make_node_eval_step(self.model, self.comm), "test")
        self.log.info("test acc %.4f", acc)
        self.metrics.log("test", acc=acc, host_peak_rss_mb=host_peak_rss_mb(),
                         **self._peak_memory(), **self._launches())
        return {"test_acc": acc}
