"""Sparse full-graph citation runner, on one device.

Counterpart of ``lanczosnet_tpu/train/sparse_citation_runner.py``
without its mesh: the protocol of ``CitationRunner`` (Planetoid splits,
full-batch steps, early stopping on validation accuracy, a test of the
best snapshot) with the graph operator held as COO edges
(``ops/sparse.py``), so memory grows with the edges and not with N².
This is the path of the 1M- and 10M-node configs.

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

``train.remat`` trades recomputation for memory: ``full`` recomputes
the whole forward in the backward, ``dots`` saves only the matrix
products' outputs (a selective-checkpoint policy), ``layers``
recomputes one layer at a time (GCN and LanczosNet, the form that fits
the 10M-node step in the JAX package). Gradients are those of no remat.

The JAX runner initializes flax parameters on a tiny twin of the graph
because flax draws them by running the model on data; a torch module
draws them from shapes alone, so this runner has no twin. Options for
more than one device (``train.num_devices`` > 1, ``train.shard``) raise,
naming ROADMAP A11 (``train/unported.py``).
"""

from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Mapping

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
from lanczosnet_torch.models.sparse_nodes import build_sparse_model
from lanczosnet_torch.ops.precision import bf16_f32_accumulation
from lanczosnet_torch.ops.sparse import (
    sparse_lanczos_ritz,
    sparse_row_stochastic_operator,
    sparse_sym_operator,
)
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.train.citation_runner import citation_graph
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.unported import refuse_unported
from lanczosnet_torch.utils.device import resolve_device
from lanczosnet_torch.utils.logger import MetricsLogger, get_logger

REMAT_MODES = {"": None, "false": None, "none": None, "0": None,
               "full": "full", "true": "full", "1": "full", "dots": "dots", "layers": "layers"}
# the products whose outputs `remat: dots` keeps, as JAX's
# dots_with_no_batch_dims_saveable keeps its dot_generals
_SAVED_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def remat_mode(tcfg: Mapping) -> str | None:
    """``train.remat`` → None, ``full``, ``dots`` or ``layers``; anything
    else raises."""
    raw = str(tcfg.get("remat", "") or "").lower()
    if raw not in REMAT_MODES:
        raise ValueError(f"train.remat must be 'full', 'dots' or 'layers', got {raw!r}")
    return REMAT_MODES[raw]


def _save_products(ctx, op, *args, **kwargs):
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


class SparseCitationRunner:
    def __init__(self, config: Mapping, device: str | torch.device | None = None,
                 graph: dict | None = None):
        """``graph``, where given, is the dict ``dataset`` would make (a
        caller that trains several configs on one graph makes it once)."""
        refuse_unported(config)
        self.config = config
        self.device = resolve_device(device)
        self.log = get_logger()
        self.run_dir = Path(config["save_dir"])
        self.metrics = MetricsLogger(self.run_dir / "metrics.jsonl")
        self.ckpt = Checkpointer(self.run_dir)
        mcfg = dict(config["model"])
        self.remat = remat_mode(config["train"])
        self.seconds = {}

        t0 = time.perf_counter()
        if graph is None:
            graph = sparse_citation_graph(config["dataset"])
        self.seconds["graph"] = time.perf_counter() - t0
        n = graph["features"].shape[0]
        edges = graph["edges"] if "edges" in graph else np.argwhere(np.triu(graph["adj"], 1) > 0)
        t0 = time.perf_counter()
        build = sparse_row_stochastic_operator if mcfg["name"] == "DCNN" else sparse_sym_operator
        self.op = build(edges, n, device=self.device)
        self._sync()
        self.seconds["operator"] = time.perf_counter() - t0

        self.model = build_sparse_model(mcfg, graph["features"].shape[1], int(graph["num_class"]))
        self.model.init_weights(torch.Generator().manual_seed(int(config["seed"])))
        self.model.to(self.device)
        self.model.set_remat_layers(self.remat == "layers")
        # stored in the compute dtype: the model's first op is that cast
        self.x = torch.from_numpy(graph["features"]).to(self.device, self.model.dtype)
        self.labels = torch.from_numpy(graph["labels"].astype(np.int64)).to(self.device)
        self.splits = {s: torch.from_numpy(graph[f"{s}_mask"].astype(np.float32)).to(self.device)
                       for s in ("train", "val", "test")}

        t0 = time.perf_counter()
        self.extras = ()
        if mcfg["name"] == "LanczosNet":
            with torch.no_grad():
                self.extras = sparse_lanczos_ritz(self.op, int(mcfg.get("num_eig_vec", 20)))
        elif mcfg["name"] == "GPNN":
            part = sparse_spectral_partition(self.op, int(mcfg.get("num_partition", 2)),
                                             seed=int(config["seed"]))
            self.extras = (torch.from_numpy(part).to(self.device),)
        self._sync()
        self.seconds["extras"] = time.perf_counter() - t0
        self.metrics.log("setup", **{f"{k}_s": v for k, v in self.seconds.items()})
        self.log.info(
            "sparse citation runner: model=%s dataset=%s nodes=%d edges=%d classes=%d "
            "dtype=%s remat=%s device=%s | graph %.1fs, operator %.1fs, extras %.1fs",
            mcfg["name"], config["dataset"].get("name", "synthetic"), n, self.op.num_edges,
            graph["num_class"], self.model.dtype, self.remat, self.device,
            self.seconds["graph"], self.seconds["operator"], self.seconds["extras"],
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward(self) -> torch.Tensor:
        """The logits ``[N, C]`` of the whole graph, in the model's mode."""
        return self.model(self.x, self.op, *self.extras)

    def loss(self, logits: torch.Tensor, split: str = "train") -> torch.Tensor:
        """Mean cross-entropy (in float32) over the nodes of ``split``."""
        ce = F.cross_entropy(logits.to(torch.float32), self.labels, reduction="none")
        m = self.splits[split]
        return (ce * m).sum() / m.sum().clamp_min(1.0)

    def make_train_step(self, optimizer, scheduler=None, grad_clip=None):
        """``() → loss``: one full-batch step in training mode, the
        forward recomputed in the backward as ``train.remat`` says."""
        fwd = self.forward
        if self.remat == "full":
            fwd = functools.partial(checkpoint, self.forward, use_reentrant=False)
        elif self.remat == "dots":
            fwd = functools.partial(
                checkpoint, self.forward, use_reentrant=False,
                context_fn=functools.partial(create_selective_checkpoint_contexts,
                                             _save_products))

        def train_step() -> torch.Tensor:
            self.model.train()
            optimizer.zero_grad(set_to_none=True)
            with bf16_f32_accumulation():
                loss = self.loss(fwd())
                loss.backward()
            if grad_clip:
                torch.nn.utils.clip_grad_norm_(self.model.parameters(), float(grad_clip))
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            return loss.detach()

        return train_step

    @torch.no_grad()
    def accuracy(self, split: str) -> float:
        self.model.eval()
        with bf16_f32_accumulation():
            pred = self.forward().argmax(-1)
        m = self.splits[split]
        return float(((pred == self.labels).to(m.dtype) * m).sum() / m.sum().clamp_min(1.0))

    def _state(self, optimizer, scheduler) -> dict:
        return {"model": self.model.state_dict(), "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()}

    def _restore_file(self, path) -> dict:
        return Checkpointer.restore_file(path, self.device, f"Sparse{self.config['model']['name']}")

    def train(self) -> dict:
        tcfg = self.config["train"]
        optimizer, scheduler, grad_clip = build_optimizer(self.model.parameters(), tcfg, 1)
        train_step = self.make_train_step(optimizer, scheduler, grad_clip)
        torch.manual_seed(int(self.config["seed"]))  # the dropout stream
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
            group = min(group_size, max_epoch - epoch)
            for _ in range(group):
                loss = train_step()
            loss = float(loss)  # a failed step surfaces here, before the eval
            epoch += group
            val_acc = self.accuracy("val")
            self.metrics.log("epoch", epoch=epoch - 1, epochs=group,
                             seconds=time.perf_counter() - t0)
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
        self.model.load_state_dict(self.ckpt.restore("best", self.device)["model"], strict=True)
        test_acc = self.accuracy("test")
        self.log.info("best val acc %.4f (epoch %d) | test acc %.4f | %.1fs",
                      best_val, best_epoch, test_acc, wall)
        self.metrics.log("test", acc=test_acc, best_val=best_val, wall_s=wall)
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
        self.metrics.log("test", acc=acc)
        return {"test_acc": acc}
