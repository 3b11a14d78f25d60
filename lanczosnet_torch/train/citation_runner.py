"""Full-graph citation experiment runner (Cora/Citeseer/Pubmed family).

Counterpart of ``lanczosnet_tpu/train/citation_runner.py`` on one
device: semi-supervised node classification on one large graph in the
Planetoid protocol. Full-batch gradient steps on the training-node
mask, validation every epoch, a snapshot of the best validation
accuracy, early stopping, resume, and test on the best snapshot. The
graph stays on the device for the whole run.

    runner = CitationRunner(config)            # on the card
    runner = CitationRunner(config, "cpu")     # where the caller asks
    runner.train(); runner.test()

``config`` is a plain mapping with the keys of ``configs/cora_*.yaml``:
``dataset``, ``model``, ``train``, ``test``, ``seed``, ``save_dir``.
Options the port does not run yet (``train.num_devices`` > 1,
``train.tp``, ``train.tensorboard``, ``train.profile``, …) raise,
naming their ROADMAP item (``train/unported.py``, the table
``QM8Runner`` checks too); ``train.prng_impl``, JAX's choice of random
bit generator, is accepted and has no effect.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Mapping

import torch

from lanczosnet_torch.data.citation import (
    import_planetoid,
    pack_citation,
    synthetic_citation_graph,
)
from lanczosnet_torch.models import build_model
from lanczosnet_torch.train.checkpoint import Checkpointer
from lanczosnet_torch.train.node_step import make_node_eval_step, make_node_train_step
from lanczosnet_torch.train.optim import build_optimizer
from lanczosnet_torch.train.unported import refuse_unported
from lanczosnet_torch.utils.device import resolve_device
from lanczosnet_torch.utils.logger import MetricsLogger, get_logger


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
        self.device = resolve_device(device)
        self.log = get_logger()
        self.run_dir = Path(config["save_dir"])
        self.metrics = MetricsLogger(self.run_dir / "metrics.jsonl")
        self.ckpt = Checkpointer(self.run_dir)

        dcfg = config["dataset"]
        mcfg = dict(config["model"])
        mcfg["task"] = "node"
        # only LanczosNet reads Ritz pairs from the batch; AdaLanczosNet
        # computes its own inside the forward
        num_eig_vec = int(mcfg.get("num_eig_vec", 20)) if mcfg["name"] == "LanczosNet" else 0

        graph = citation_graph(dcfg)
        self.batch, self.splits = pack_citation(
            graph,
            pad_to=1,
            operator_kind=dcfg.get("operator_kind", "sym"),
            num_eig_vec=num_eig_vec,
            num_cluster=int(mcfg.get("num_partition", 0)) if mcfg["name"] == "GPNN" else 0,
            device=self.device,
        )
        self.n_pad = self.batch.n_max

        mcfg.setdefault("num_atom", 2)
        mcfg["num_task"] = int(graph["num_class"])
        # widths that flax infers from the first batch
        mcfg["num_edge_type"] = self.batch.num_ops - 1
        mcfg["node_feat_dim"] = self.batch.node_feat.shape[-1]
        self.model = build_model(mcfg)
        self.model.init_weights(torch.Generator().manual_seed(int(config["seed"])))
        self.model.to(self.device)
        self.log.info(
            "citation runner: model=%s dataset=%s nodes=%d (pad %d) classes=%d device=%s",
            mcfg["name"], dcfg.get("name", "cora"), int(self.batch.mask.sum()),
            self.n_pad, graph["num_class"], self.device,
        )

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
        train_step = make_node_train_step(self.model, optimizer, scheduler, grad_clip)
        eval_step = make_node_eval_step(self.model)
        torch.manual_seed(int(self.config["seed"]))  # the dropout stream

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
            loss = float(train_step(self.batch, self.splits["train"]))
            val_acc = self._accuracy(eval_step, "val")
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

        self._load_state(self.ckpt.restore("best", self.device))
        test_acc = self._accuracy(eval_step, "test")
        self.log.info(
            "best val acc %.4f (epoch %d) | test acc %.4f | %.1fs total",
            best_val, best_epoch, test_acc, wall,
        )
        self.metrics.log("test", acc=test_acc, best_val=best_val, wall_s=wall)
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
        acc = self._accuracy(make_node_eval_step(self.model), "test")
        self.log.info("test acc %.4f", acc)
        self.metrics.log("test", acc=acc)
        return {"test_acc": acc}
