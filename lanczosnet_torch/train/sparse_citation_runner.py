"""Sparse full-graph citation runner, on one device or sharded over ranks.

Counterpart of ``lanczosnet_tpu/train/sparse_citation_runner.py``: the
protocol of ``CitationRunner`` (Planetoid splits, full-batch steps,
early stopping on validation accuracy, a test of the best snapshot)
with the graph operator held as COO edges (``ops/sparse.py``), so memory
grows with the edges and not with N². This is the path of the 1M- and
10M-node configs.

    runner = SparseCitationRunner(config)          # on the card
    runner = SparseCitationRunner(config, "cpu")   # where the caller asks
    runner.train(); runner.test()

Select it with ``runner: SparseCitationRunner``. The graph comes from
``dataset.source``: ``synthetic`` (the dense stand-in generator of
``name`` at ``scale``), ``synthetic_edges`` (the O(E) generator:
``num_nodes``, ``num_class``, ``feat_dim``, ``avg_degree``) or
``planetoid`` (the files in ``data_dir``). All nine ``model.name``s map
to ``models/sparse_nodes.py``: DCNN gets the row-stochastic operator,
the others the symmetric one; LanczosNet gets the Ritz pairs of the
operator, computed once here; GPNN a partition of the graph
(``data/partition.py:sparse_spectral_partition``). Features are stored
in ``model.dtype``, the first thing the model casts them to.

``train.num_devices: D > 1`` shards the graph over the D ranks of a
process group (``parallel/multihost.py``; the CLI starts them), each
rank one process with this runner; ``train.shard`` picks the form:

- ``edges`` (the default): each rank holds E/D edges and every node
  array whole; logits come out whole on every rank, and each rank's
  loss is the whole loss over D;
- ``nodes``: each rank holds a block of N/D nodes, the edges into it,
  and its rows of every node array (the features, the labels, the Ritz
  vectors); the sources come through an all-gather;
- ``nodes_ring``: the same blocks, the sources coming round the ring
  one block a hop, so no rank holds more than two blocks of them.

Rank 0 draws the graph, builds the operator and cuts every rank's piece
(``parallel/mesh.py``); each rank receives its own. The Ritz pairs are
computed sharded (``ops/sparse.py:sparse_lanczos_ritz``); GPNN's
partition is rank 0's, of the whole graph with its padding nodes, then
cut. Each rank's loss is its share of the total (node modes: its masked
sum over the global count); the parameter gradients and the loss get
one all-reduce a step, before clipping and the optimizer, so weight
decay sees the summed gradient once and the parameters stay equal on
every rank. Dropout draws from the runner's own generator, seeded
when the runner is built: one stream on one device and on every rank in
edge mode (the activations are replicated), a stream of its own per
rank in the node modes. Only rank 0 writes checkpoints
(``metrics.jsonl`` and ``run.log`` too: rank r writes
``metrics.rank<r>.jsonl``); the others read after a barrier.

``train.remat`` trades recomputation for memory: ``full`` recomputes
the whole forward in the backward, ``dots`` saves only the matrix
products' outputs (a selective-checkpoint policy), ``layers``
recomputes one layer at a time (GCN and LanczosNet, the form that fits
the 10M-node step in the JAX package). Gradients are those of no remat:
the recomputation replays the dropout stream.

The JAX runner initializes flax parameters on a tiny twin of the graph
because flax draws them by running the model on data; a torch module
draws them from shapes alone, so this runner has no twin.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from lanczosnet_torch.data.citation import synthetic_citation_edges
from lanczosnet_torch.data.partition import sparse_spectral_partition
from lanczosnet_torch.models.base import set_dropout_generator
from lanczosnet_torch.models.sparse_nodes import build_sparse_model, replaying
from lanczosnet_torch.ops.precision import bf16_f32_accumulation
from lanczosnet_torch.ops.sparse import (
    coo_arrays,
    sparse_lanczos_ritz,
    sparse_op_from_arrays,
)
from lanczosnet_torch.parallel import mesh, multihost
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.train.citation_runner import citation_graph
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.unported import refuse_unported
from lanczosnet_torch.utils.device import resolve_device
from lanczosnet_torch.utils.logger import MetricsLogger, get_logger
from lanczosnet_torch.utils.memory import host_peak_rss_mb

REMAT_MODES = {"": None, "false": None, "none": None, "0": None,
               "full": "full", "true": "full", "1": "full", "dots": "dots", "layers": "layers"}
SHARD_MODES = ("edges", "nodes", "nodes_ring")
# the products whose outputs `remat: dots` keeps, as JAX's
# dots_with_no_batch_dims_saveable keeps its dot_generals
_SAVED_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
SPLITS = ("train", "val", "test")


def remat_mode(tcfg: Mapping) -> str | None:
    """``train.remat`` → None, ``full``, ``dots`` or ``layers``; anything
    else raises."""
    raw = str(tcfg.get("remat", "") or "").lower()
    if raw not in REMAT_MODES:
        raise ValueError(f"train.remat must be 'full', 'dots' or 'layers', got {raw!r}")
    return REMAT_MODES[raw]


def shard_mode(tcfg: Mapping) -> str | None:
    """``train.shard`` where ``train.num_devices`` > 1 (``edges`` when
    unset), else None; another value raises."""
    if int(tcfg.get("num_devices", 1) or 1) <= 1:
        return None
    mode = str(tcfg.get("shard") or "edges")
    if mode not in SHARD_MODES:
        raise ValueError(f"train.shard must be one of {SHARD_MODES}, got {mode!r}")
    return mode


def dropout_seed(seed: int, mode: str | None, rank: int) -> int:
    """The seed of a rank's dropout generator: the run's seed where the
    activations are replicated, one of its own per rank where each rank
    holds a block of nodes."""
    if mode in ("nodes", "nodes_ring"):
        return (seed * 1_000_003 + rank + 1) % 2**63
    return seed


def save_products(ctx, op, *args, **kwargs):
    """The selective checkpoint policy of ``remat: dots``: keep the matrix
    products' outputs, recompute the rest in the backward."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def sparse_citation_graph(dcfg: Mapping) -> dict:
    """The graph of a ``dataset:`` section, as the JAX runner reads it."""
    if dcfg.get("source", "synthetic") == "synthetic_edges":
        return synthetic_citation_edges(
            int(dcfg.get("num_nodes", 100_000)),
            num_class=int(dcfg.get("num_class", 10)),
            feat_dim=int(dcfg.get("feat_dim", 256)),
            avg_degree=float(dcfg.get("avg_degree", 5.0)),
            seed=int(dcfg.get("seed", 7)),
        )
    return citation_graph(dcfg)


def graph_edges(graph: dict) -> np.ndarray:
    return graph["edges"] if "edges" in graph else np.argwhere(np.triu(graph["adj"], 1) > 0)


class SparseCitationRunner:
    def __init__(self, config: Mapping, device: str | torch.device | None = None,
                 graph: dict | None = None):
        """``graph``, where given, is the dict ``dataset`` would make (a
        caller that trains several configs on one graph makes it once;
        sharded, rank 0's is used)."""
        refuse_unported(config, "SparseCitationRunner")
        self.config = config
        tcfg = config["train"]
        self.shard = shard_mode(tcfg)
        self.remat = remat_mode(tcfg)
        self.world = None
        if self.shard is not None:
            self.world = multihost.initialize(int(tcfg["num_devices"]), device)
            self.device = self.world.device
        else:
            self.device = resolve_device(device)
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
        mcfg = dict(config["model"])
        self.seconds = {}

        if self.shard is None:
            graph = self._build_single(mcfg, graph)
        else:
            graph = self._build_sharded(mcfg, graph)
        self.model = build_sparse_model(mcfg, graph["in_dim"], graph["num_class"])
        self.model.init_weights(torch.Generator().manual_seed(int(config["seed"])))
        self.model.to(self.device)
        self.model.set_remat_layers(self.remat == "layers")
        self.dropout_generator = torch.Generator(self.device).manual_seed(
            dropout_seed(int(config["seed"]), self.shard, self.rank))
        set_dropout_generator(self.model, self.dropout_generator)
        # stored in the compute dtype: the model's first op is that cast
        self.x = torch.from_numpy(graph["features"]).to(self.device, self.model.dtype)
        self.labels = torch.from_numpy(graph["labels"].astype(np.int64)).to(self.device)
        self.splits = {s: torch.from_numpy(graph[f"{s}_mask"].astype(np.float32)).to(self.device)
                       for s in SPLITS}
        self.split_count = graph["split_count"]

        t0 = time.perf_counter()
        self.extras = ()
        if mcfg["name"] == "LanczosNet":
            with torch.no_grad():
                self.extras = sparse_lanczos_ritz(self.op, int(mcfg.get("num_eig_vec", 20)))
        elif mcfg["name"] == "GPNN":
            self.extras = (torch.from_numpy(graph["part"]).to(self.device),)
        self._sync()
        self.seconds["extras"] = time.perf_counter() - t0 + self.seconds.pop("partition", 0.0)
        setup = {f"{k}_s": v for k, v in self.seconds.items()}
        if self.world is not None:
            setup.update(self.world.describe(), shard=self.shard, n_true=graph["n_true"],
                         num_edges=graph["num_edges"], comm=self.comm.stats.as_dict())
        else:
            setup.update(device=str(self.device))
        self.metrics.log("setup", **setup, host_peak_rss_mb=host_peak_rss_mb(),
                         **self._peak_memory())
        self.log.info(
            "sparse citation runner: model=%s dataset=%s nodes=%d edges=%d classes=%d "
            "dtype=%s remat=%s device=%s | %s", mcfg["name"],
            config["dataset"].get("name", "synthetic"), graph["n_true"], graph["num_edges"],
            graph["num_class"], self.model.dtype, self.remat, self.device,
            ", ".join(f"{k} {v:.1f}s" for k, v in self.seconds.items()))
        if self.world is not None:
            self.log.info("sharded: %s over %d ranks, backend %s, %d rank(s) a card, this "
                          "rank %d on %s", self.shard, self.world.size, self.world.backend,
                          self.world.ranks_per_card, self.rank, self.device)

    # ------------------------------------------------------------------ set-up
    def _build_single(self, mcfg: dict, graph: Optional[dict]) -> dict:
        t0 = time.perf_counter()
        if graph is None:
            graph = sparse_citation_graph(self.config["dataset"])
        self.seconds["graph"] = time.perf_counter() - t0
        n = graph["features"].shape[0]
        t0 = time.perf_counter()
        kind = "row_stochastic" if mcfg["name"] == "DCNN" else "sym"
        self.op = sparse_op_from_arrays(coo_arrays(graph_edges(graph), n, kind), n, self.device)
        self._sync()
        self.seconds["operator"] = time.perf_counter() - t0
        out = {k: graph[k] for k in ("features", "labels", *(f"{s}_mask" for s in SPLITS))}
        out.update(in_dim=graph["features"].shape[1], num_class=int(graph["num_class"]),
                   n_true=n, num_edges=self.op.num_edges,
                   split_count={s: float(graph[f"{s}_mask"].sum()) for s in SPLITS})
        if mcfg["name"] == "GPNN":
            t0 = time.perf_counter()
            out["part"] = sparse_spectral_partition(self.op, int(mcfg.get("num_partition", 2)),
                                                    seed=int(self.config["seed"]))
            self.seconds["partition"] = time.perf_counter() - t0
        return out

    def _cut(self, mcfg: dict, graph: Optional[dict]) -> tuple[dict, dict]:
        """Rank 0: draw the graph, build the operator and cut every rank's
        piece → (meta, {name: [D, ...] array})."""
        d = self.world.size
        t0 = time.perf_counter()
        if graph is None:
            graph = sparse_citation_graph(self.config["dataset"])
        self.seconds["graph"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = graph["features"].shape[0]
        edges = graph_edges(graph)
        kind = "row_stochastic" if mcfg["name"] == "DCNN" else "sym"
        arrays = coo_arrays(edges, n, kind)
        num_edges = len(arrays["row"])
        self.seconds["operator"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_pad = n
        if self.shard == "edges":
            pieces = mesh.shard_sparse_arrays(arrays["row"], arrays["col"], arrays["val"], n, d)
        elif self.shard == "nodes":
            pieces, n_pad = mesh.node_shard_arrays(arrays["row"], arrays["col"], arrays["val"],
                                                   n, d)
        else:
            pieces, n_pad = mesh.ring_shard_arrays(arrays["row"], arrays["col"], arrays["val"],
                                                   n, d)
        del arrays
        node = {"features": graph["features"].astype(np.float32),
                "labels": graph["labels"].astype(np.int64),
                **{f"{s}_mask": graph[f"{s}_mask"].astype(np.float32) for s in SPLITS}}
        if mcfg["name"] == "GPNN":
            # the partition of the whole graph with its padding nodes (they
            # are isolated), so that its ids line up with the node blocks
            t1 = time.perf_counter()
            whole = sparse_op_from_arrays(coo_arrays(edges, n_pad, "sym"), n_pad, self.device)
            part = sparse_spectral_partition(whole, int(mcfg.get("num_partition", 2)),
                                             seed=int(self.config["seed"]))
            del whole
            node["part"] = part[:n] if self.shard == "edges" else part
            self.seconds["partition"] = time.perf_counter() - t1
        if self.shard != "edges":
            node = {k: mesh.shard_node_array(v, n_pad, d) for k, v in node.items()}
        pieces.update({f"node.{k}": v for k, v in node.items()})
        self.seconds["pieces"] = time.perf_counter() - t0
        meta = {"n_true": n, "n_pad": n_pad, "num_edges": num_edges,
                "in_dim": int(graph["features"].shape[1]), "num_class": int(graph["num_class"]),
                "split_count": {s: float(graph[f"{s}_mask"].sum()) for s in SPLITS},
                "arrays": {k: (v.shape, v.dtype.str) for k, v in pieces.items()},
                "seconds": dict(self.seconds)}
        return meta, pieces

    def _build_sharded(self, mcfg: dict, graph: Optional[dict]) -> dict:
        """Every rank: receive this rank's piece from rank 0 and build its
        operator and node arrays."""
        comm, d = self.comm, self.world.size
        meta, pieces = self._cut(mcfg, graph) if self.rank == 0 else (None, None)
        del graph
        t0 = time.perf_counter()
        meta = comm.broadcast_object(meta)
        self.seconds = dict(meta["seconds"])
        replicated = self.shard == "edges"
        mine = {}
        for key, (shape, dtype) in meta["arrays"].items():
            whole = pieces[key] if pieces is not None else None
            if replicated and key.startswith("node."):
                mine[key] = comm.broadcast_array(whole, shape, np.dtype(dtype))
            else:
                mine[key] = comm.scatter_arrays(None if whole is None else list(whole),
                                                shape[1:], np.dtype(dtype))
        del pieces
        self.seconds["scatter"] = time.perf_counter() - t0
        n_loc = meta["n_pad"] // d
        if self.shard == "nodes_ring":
            self.op = mesh.ring_op_piece(mine, n_loc, comm, self.device, n_true=meta["n_true"])
        elif self.shard == "nodes":
            self.op = mesh.sparse_op_piece(mine, n_loc, comm, "nodes", self.device,
                                           n_true=meta["n_true"])
        else:
            self.op = mesh.sparse_op_piece(mine, meta["n_true"], comm, "edges", self.device)
        self._sync()
        out = {k[len("node."):]: v for k, v in mine.items() if k.startswith("node.")}
        out.update({k: meta[k] for k in ("in_dim", "num_class", "n_true", "num_edges",
                                         "split_count")})
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------- steps
    @property
    def node_sharded(self) -> bool:
        return self.shard in ("nodes", "nodes_ring")

    def forward(self) -> torch.Tensor:
        """The logits of this rank's nodes (sharded by nodes: its block;
        else the whole graph), in the model's mode."""
        return self.model(self.x, self.op, *self.extras)

    def _count(self, split: str) -> float:
        """The nodes of ``split`` in the whole graph (at least 1)."""
        return max(self.split_count[split], 1.0)

    def loss(self, logits: torch.Tensor, split: str = "train") -> torch.Tensor:
        """Mean cross-entropy (in float32) over the nodes of ``split``;
        sharded, this rank's share of it (the shares sum to the mean)."""
        ce = F.cross_entropy(logits.to(torch.float32), self.labels, reduction="none")
        m = self.splits[split]
        share = (ce * m).sum() / self._count(split)
        return share / self.world.size if self.shard == "edges" else share

    def make_train_step(self, optimizer, scheduler=None, grad_clip=None):
        """``() → loss``: one full-batch step in training mode, the
        forward recomputed in the backward as ``train.remat`` says; the
        loss returned is the whole one on every rank."""
        params = [p for p in self.model.parameters() if p.requires_grad]

        def forward():
            if self.remat is None or self.remat == "layers":
                return self.forward()
            fwd = replaying(self.forward, self.dropout_generator)
            if self.remat == "full":
                return checkpoint(fwd, use_reentrant=False)
            return checkpoint(fwd, use_reentrant=False, context_fn=lambda: (
                create_selective_checkpoint_contexts(save_products)))

        def train_step() -> torch.Tensor:
            self.model.train()
            optimizer.zero_grad(set_to_none=True)
            with bf16_f32_accumulation():
                loss = self.loss(forward())
                loss.backward()
            loss = loss.detach()
            if self.comm is not None:
                # the shares' sums: the gradients and the loss, one all-reduce
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
                *summed, loss = self.comm.all_reduce_flat([*grads, loss.reshape(1)])
                for p, g in zip(params, summed):
                    p.grad = g
                loss = loss[0]
            if grad_clip:
                torch.nn.utils.clip_grad_norm_(params, float(grad_clip))
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            return loss

        return train_step

    @torch.no_grad()
    def accuracy(self, split: str) -> float:
        self.model.eval()
        with bf16_f32_accumulation():
            pred = self.forward().argmax(-1)
        m = self.splits[split]
        correct = ((pred == self.labels).to(m.dtype) * m).sum()
        if self.node_sharded:
            correct = self.comm.all_reduce(correct)
        return float(correct / self._count(split))

    @torch.no_grad()
    def gathered_logits(self) -> torch.Tensor:
        """The eval-mode logits of the whole graph ``[N, C]`` on every rank
        (node-sharded: the blocks all-gathered, the padding cut)."""
        self.model.eval()
        with bf16_f32_accumulation():
            logits = self.forward()
        if self.node_sharded:
            logits = self.comm.all_gather(logits)[: self.op.n_true]
        return logits

    # ---------------------------------------------------------- run protocol
    def _state(self, optimizer, scheduler) -> dict:
        return {"model": self.model.state_dict(), "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()}

    def _restore_file(self, path) -> dict:
        return Checkpointer.restore_file(path, self.device, f"Sparse{self.config['model']['name']}")

    def _peak_memory(self) -> dict:
        if self.device.type != "cuda":
            return {}
        return {"peak_memory_mb": torch.cuda.max_memory_allocated(self.device) / 2**20}

    def train(self) -> dict:
        tcfg = self.config["train"]
        optimizer, scheduler, grad_clip = build_optimizer(self.model.parameters(), tcfg, 1)
        train_step = self.make_train_step(optimizer, scheduler, grad_clip)
        group_size = max(1, int(tcfg.get("valid_epoch", 1)))
        max_epoch = int(tcfg.get("max_epoch", 200))
        patience = int(tcfg.get("patience", 50))
        display = int(tcfg.get("display_iter", 20))
        snapshot_every = max(1, int(tcfg.get("snapshot_epoch", 50)))
        best_val, best_epoch, epoch = -1.0, -1, 0
        if tcfg.get("is_resume") and self.ckpt.exists("latest"):
            state = self.ckpt.restore("latest", self.device)
            self.model.load_state_dict(state["model"], strict=True)
            optimizer.load_state_dict(state["optimizer"])
            scheduler.load_state_dict(state["scheduler"])
            epoch = int((self.ckpt.meta("latest") or {}).get("epoch", -1)) + 1
            best_meta = self.ckpt.meta("best") or {}
            best_val = float(best_meta.get("val_acc", -1.0))
            best_epoch = int(best_meta.get("epoch", -1))
            self.log.info("resumed from epoch %d (best val so far %.4f)", epoch, best_val)
        elif tcfg.get("resume_model"):
            self.model.load_state_dict(self._restore_file(tcfg["resume_model"])["model"],
                                       strict=True)
            self.log.info("warm-started from %s", tcfg["resume_model"])

        t_run = time.perf_counter()
        while epoch < max_epoch:
            t0 = time.perf_counter()
            comm0 = None if self.comm is None else self.comm.stats.copy()
            group = min(group_size, max_epoch - epoch)
            for _ in range(group):
                loss = train_step()
            loss = float(loss)  # a failed step surfaces here, before the eval
            step_s = time.perf_counter() - t0
            comm = {} if comm0 is None else {"comm": self.comm.stats.minus(comm0)}
            epoch += group
            val_acc = self.accuracy("val")
            self.metrics.log("epoch", epoch=epoch - 1, epochs=group, step_seconds=step_s,
                             seconds=time.perf_counter() - t0, **comm)
            if (epoch - group) % display < group:
                self.log.info("epoch %d | train CE %.4f | val acc %.4f", epoch - 1, loss, val_acc)
                self.metrics.log("train", epoch=epoch - 1, loss=loss, val_acc=val_acc)
            if val_acc > best_val:
                best_val, best_epoch = val_acc, epoch - 1
                self.ckpt.save("best", self._state(optimizer, scheduler),
                               {"epoch": epoch - 1, "val_acc": val_acc})
            if epoch // snapshot_every != (epoch - group) // snapshot_every:
                self.ckpt.save("latest", self._state(optimizer, scheduler), {"epoch": epoch - 1})
            if epoch - 1 - best_epoch > patience:
                self.log.info("early stop at epoch %d", epoch - 1)
                break
        wall = time.perf_counter() - t_run
        # sharded: rank 0 may still be writing "best" when the others get here
        multihost.barrier()
        self.model.load_state_dict(self.ckpt.restore("best", self.device)["model"], strict=True)
        test_acc = self.accuracy("test")
        self.log.info("best val acc %.4f (epoch %d) | test acc %.4f | %.1fs",
                      best_val, best_epoch, test_acc, wall)
        self.metrics.log("test", acc=test_acc, best_val=best_val, wall_s=wall,
                         host_peak_rss_mb=host_peak_rss_mb(), **self._peak_memory())
        return {"best_val_acc": best_val, "test_acc": test_acc}

    def test(self) -> dict:
        path = (self.config.get("test") or {}).get("test_model")
        if path:
            state = self._restore_file(path)
        elif self.ckpt.exists("best"):
            state = self.ckpt.restore("best", self.device)
        else:
            raise FileNotFoundError("no checkpoint: set test.test_model or train")
        self.model.load_state_dict(state["model"], strict=True)
        acc = self.accuracy("test")
        self.log.info("test acc %.4f", acc)
        self.metrics.log("test", acc=acc, host_peak_rss_mb=host_peak_rss_mb(),
                         **self._peak_memory())
        return {"test_acc": acc}
